"""Device operations: the fused-layer kernel and the plain-torch state ops."""
