"""Backend registry: set_target / get_active_backend (a copy of
``rocquantum_tpu/core.py`` whose registry points at this package's
backends).

API-parity rebuild of reference rocquantum/core.py:13-56, plus a ``local``
target that runs on the in-process simulator: ``set_target("local")`` runs
on the card, ``set_target("local", device="cpu")`` on the CPU (keyword
arguments go to the backend's constructor).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Type

from .backends.base import RocqBackend

_AVAILABLE_BACKENDS: Dict[str, str] = {
    # --- Implemented Backends ---
    "ionq": "rocquantum_tpu_torch.backends.ionq.IonQBackend",
    "infleqtion": "rocquantum_tpu_torch.backends.infleqtion.InfleqtionBackend",
    "pasqal": "rocquantum_tpu_torch.backends.pasqal.PasqalBackend",
    "quantinuum": "rocquantum_tpu_torch.backends.quantinuum.QuantinuumBackend",
    "qristal":
        "rocquantum_tpu_torch.backends.qristal.QuantumBrillianceBackend",
    "rigetti": "rocquantum_tpu_torch.backends.rigetti.RigettiBackend",
    "local": "rocquantum_tpu_torch.backends.local.LocalBackend",
    # --- Promoted Type A clients (skeletons in the reference) ---
    "iqm": "rocquantum_tpu_torch.backends.iqm.IQMBackend",
    "xanadu": "rocquantum_tpu_torch.backends.xanadu.XanaduBackend",
    "quera": "rocquantum_tpu_torch.backends.quera.QuEraBackend",
    "orca": "rocquantum_tpu_torch.backends.orca.OrcaBackend",
    "seeqc": "rocquantum_tpu_torch.backends.seeqc.SeeqcBackend",
    "quantum_machines": "rocquantum_tpu_torch.backends.quantum_machines."
                        "QuantumMachinesBackend",
    "alice_bob": "rocquantum_tpu_torch.backends.alice_bob.AliceBobBackend",
}

_ACTIVE_BACKEND: Optional[RocqBackend] = None


def set_target(name: str, **kwargs) -> None:
    """Select, instantiate, and authenticate a quantum backend."""
    global _ACTIVE_BACKEND
    if name not in _AVAILABLE_BACKENDS:
        raise ValueError(
            f"Backend '{name}' not recognized. Available: "
            f"{list(_AVAILABLE_BACKENDS.keys())}")
    import_path = _AVAILABLE_BACKENDS[name]
    try:
        module_path, class_name = import_path.rsplit(".", 1)
        module = importlib.import_module(module_path)
        backend_class: Type[RocqBackend] = getattr(module, class_name)
    except (ImportError, AttributeError) as e:
        raise ImportError(
            f"Could not import backend class '{import_path}': {e}")
    instance = backend_class(**kwargs)
    instance.authenticate()
    _ACTIVE_BACKEND = instance


def get_active_backend() -> RocqBackend:
    """Retrieve the currently active backend instance."""
    if _ACTIVE_BACKEND is None:
        raise RuntimeError("No active backend. Call set_target() first.")
    return _ACTIVE_BACKEND


def available_backends():
    return list(_AVAILABLE_BACKENDS)
