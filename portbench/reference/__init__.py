"""The benchmark's plain reference: torch and numpy only (see
statevector.py)."""
