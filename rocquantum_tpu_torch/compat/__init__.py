"""The reference-name compatibility shims on the port: counterparts of the
repository's ``rocq``, ``rocquantum``, ``rocquantum_bind``, ``rocq_hip``
and ``rocq._rocq_hip_backend`` modules, which serve the JAX package.

They live under ``rocquantum_tpu_torch.compat`` and write no
``sys.modules`` entry under the reference's top-level names (those belong
to the JAX package's shims):

    from rocquantum_tpu_torch.compat import rocq, rocquantum
    from rocquantum_tpu_torch.compat import _rocq_hip_backend

Each entry point runs on the card; where the reference's signature has no
place for a device, a ``device=`` keyword selects another (the CPU tests
pass ``device="cpu"``).
"""
