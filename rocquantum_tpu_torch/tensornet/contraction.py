"""Tensor-network contraction executor with memory-limited slicing and SVD.

Counterpart of ``rocquantum_tpu/tensornet/contraction.py`` (the reference
hipTensorNet engine: permute->GEMM pair contraction, plan replay, slicing
of a step whose working set exceeds the memory limit, SVD).

Each pairwise contraction is one ``torch.einsum`` in the sublist form
(cuBLAS CGEMM/ZGEMM on the card; the JAX package computes it with
``jnp.einsum`` outside any Pallas kernel). Every einsum runs with TF32
off, as the JAX package asks for ``Precision.HIGHEST``: TF32 on cuBLAS is
one global flag, which :func:`_full_precision` clears around the einsums
and restores afterwards.

A sliced step chooses the same ``(label, chunks)`` specs as the JAX
package, in the same order, so ``last_num_slices`` is the same. It runs as
a Python loop over slice indices: each slice contracts ``narrow`` views of
the inputs and writes its slab into the preallocated output, with
``copy_`` when only free labels are sliced and ``add_`` when a contracted
label is (partial sums). No list of slabs is kept: the step's peak is the
output plus one slab and the slab's input copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..parallel import sharded
from .pathfinder import ContractionPlan, OptimizerConfig, Pathfinder
from .tensor import Tensor, parse_einsum_spec


def _tf32_on() -> bool:
    prec = torch.backends.cuda.matmul.fp32_precision
    if prec == "none":
        prec = torch.backends.fp32_precision
    return prec == "tf32"


@contextlib.contextmanager
def _full_precision():
    """Float32 GEMMs without TF32 inside the block; the caller's setting
    afterwards. (``torch.set_float32_matmul_precision("high")`` and
    ``torch.backends.cuda.matmul.allow_tf32`` both turn TF32 on for
    complex64 GEMMs too.)"""
    if not _tf32_on():
        yield
        return
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed the legacy and the new API
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        else:
            matmul.fp32_precision = saved


def _einsum_pair(a_data, a_labels, b_data, b_labels, out_labels):
    """Contract two labeled tensors to ``out_labels`` via integer-label
    einsum at full precision."""
    ids: Dict[str, int] = {}
    for l in list(a_labels) + list(b_labels) + list(out_labels):
        if l not in ids:
            ids[l] = len(ids)
    dtype = torch.promote_types(a_data.dtype, b_data.dtype)
    a_data, b_data = a_data.to(dtype), b_data.to(dtype)
    with _full_precision():
        return torch.einsum(a_data, [ids[l] for l in a_labels],
                            b_data, [ids[l] for l in b_labels],
                            [ids[l] for l in out_labels])


def contract_pair(a: Tensor, b: Tensor,
                  keep: Sequence[str] = ()) -> Tensor:
    """Contract two tensors over their shared labels (labels in ``keep``
    survive to the output — used when other network tensors still reference
    them)."""
    shared = [l for l in a.labels if l in set(b.labels)]
    contracted = [l for l in shared if l not in set(keep)]
    out = [l for l in a.labels if l not in contracted]
    out += [l for l in b.labels if l not in set(a.labels) and l not in contracted]
    return Tensor(_einsum_pair(a.data, a.labels, b.data, b.labels, out),
                  tuple(out))


def contract_einsum(spec: str, *tensors: Union[Tensor, torch.Tensor]
                    ) -> Tensor:
    """Contract by einsum spec, e.g. 'ab,bc->ac'. Operands are Tensors or
    torch tensors."""
    inputs, out = parse_einsum_spec(spec)
    if len(inputs) != len(tensors):
        raise ValueError(f"spec has {len(inputs)} operands, got {len(tensors)}")
    ids: Dict[str, int] = {}
    for ls in list(inputs) + [out]:
        for l in ls:
            if l not in ids:
                ids[l] = len(ids)
    args = []
    for t, ls in zip(tensors, inputs):
        args.append(t.data if isinstance(t, Tensor) else t)
        args.append([ids[l] for l in ls])
    with _full_precision():
        result = torch.einsum(*args, [ids[l] for l in out])
    return Tensor(result, out)


@dataclasses.dataclass
class MemoryStats:
    """The executor's tally of one contraction: ``temp_size_in_bytes`` is
    the most bytes it held at once beyond its inputs."""
    temp_size_in_bytes: int


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class TensorNetwork:
    """Label-matched pairwise contraction network (the reference
    TensorNetwork<T>; the Python-facing rocq.TensorNetwork of
    examples/tensornet_example.py). Tensors live on ``device``: the
    simulator's, else the one given, else the CUDA device."""

    def __init__(self, simulator=None, memory_limit_bytes: Optional[int] = None,
                 device=None):
        from ..api import default_device
        self.simulator = simulator
        if simulator is not None:
            self.device = torch.device(simulator.device)
        elif device is not None:
            self.device = torch.device(device)
        else:
            self.device = default_device()
        self.tensors: List[Tensor] = []
        self.memory_limit_bytes = memory_limit_bytes
        self.last_plan: Optional[ContractionPlan] = None
        self.last_num_slices: int = 1

    def add_tensor(self, data, labels: Optional[Sequence[str]] = None) -> int:
        if isinstance(data, Tensor):
            t = Tensor(data.data.to(self.device), data.labels)
        else:
            if labels is None:
                raise ValueError("labels required when adding a raw array")
            t = Tensor.from_numpy(np.asarray(data), labels,
                                  device=self.device)
        self.tensors.append(t)
        return len(self.tensors) - 1

    # -- planning ------------------------------------------------------------

    def _plan(self, cfg: OptimizerConfig) -> ContractionPlan:
        labels = [t.labels for t in self.tensors]
        shapes = [tuple(t.shape) for t in self.tensors]
        return Pathfinder(cfg).find_optimal_path(labels, shapes)

    def _config(self, optimizer_config) -> OptimizerConfig:
        if isinstance(optimizer_config, dict):
            cfg = OptimizerConfig.from_dict(optimizer_config)
        else:
            cfg = optimizer_config or OptimizerConfig()
        if cfg.memory_limit_bytes is None:
            cfg.memory_limit_bytes = self.memory_limit_bytes
        return cfg

    # -- execution -----------------------------------------------------------

    def contract(self, optimizer_config: Union[OptimizerConfig, dict, None] = None,
                 mesh=None, axis_name: Optional[str] = None) -> Tensor:
        """Find a path and execute it, slicing any step whose working set
        (output or either input) exceeds the memory limit, and the step
        with the largest output into at least ``num_slices`` slices.

        With ``mesh`` (a ``parallel.Mesh``) and ``axis_name``, the slice
        loop of each sliced step spreads over that mesh axis (at least one
        slice a device): each mesh entry runs ``ceil(total / ndev)``
        consecutive slices into the partial output of its device (one a
        distinct device, so virtual shards of one card share one), and the
        partials combine in one in-place sum on the first device (one
        counted all-reduce)."""
        if (mesh is None) != (axis_name is None):
            raise ValueError("pass mesh and axis_name together")
        if not self.tensors:
            raise ValueError("network has no tensors")
        devices = None
        if mesh is not None:
            axis = mesh.axis_names.index(axis_name)
            devices = list(np.moveaxis(mesh.devices, axis, 0).reshape(
                mesh.shape[axis_name], -1)[:, 0])
        return self._run(self._config(optimizer_config), devices)[0]

    def compiled_memory_stats(self,
                              optimizer_config: Union[OptimizerConfig, dict,
                                                      None] = None
                              ) -> MemoryStats:
        """Run the contraction once and return the executor's tally of the
        bytes it held beyond its inputs: live intermediates, each step's
        output, its slab and the slab's input copies. (The JAX package asks
        XLA's ahead-of-time memory analysis; torch has none, so this
        contracts.)"""
        return MemoryStats(self._run(self._config(optimizer_config))[1])

    def _run(self, cfg: OptimizerConfig, devices=None
             ) -> Tuple[Tensor, int]:
        """The contraction's result and the executor's tally of the bytes
        it held beyond its inputs; ``devices`` spread each sliced step's
        slices (:meth:`contract`)."""
        plan = self._plan(cfg)
        self.last_plan = plan
        # the precision's complex itemsize, as the JAX package counts
        itemsize = torch.empty((), dtype=config.complex_dtype()).element_size()
        limit_elems = (cfg.memory_limit_bytes // itemsize
                       if cfg.memory_limit_bytes else None)
        min_slices = int(getattr(cfg, "num_slices", 0) or 0)
        if devices is not None:
            # every device must own at least one slice
            min_slices = max(min_slices, len(devices))
        self.last_num_slices = 1
        # num_slices applies to the step with the largest output even when
        # no memory limit forces slicing there
        biggest = max(plan.steps, key=lambda s: s.out_size, default=None)

        cur = list(self.tensors)
        owned = [False] * len(cur)  # True for intermediates
        live = peak = 0
        for step in plan.steps:
            a, b = cur[step.i], cur[step.j]
            rest = [t for k, t in enumerate(cur) if k not in (step.i, step.j)]
            rest_owned = [o for k, o in enumerate(owned)
                          if k not in (step.i, step.j)]
            keep = {l for t in rest for l in t.labels}
            # the working set includes the input operands as well as the
            # output: a huge-inputs/small-output contraction slices too
            step_elems = max(step.out_size, a.data.numel(), b.data.numel())
            force = min_slices if (step is biggest and min_slices > 1) else 1
            if (limit_elems is not None and step_elems > limit_elems) \
                    or force > 1:
                result, temp = self._sliced_pair(a, b, step.out_labels, keep,
                                                 limit_elems, force, devices)
            else:
                result = contract_pair(a, b, keep=keep)
                temp = _nbytes(result.data)
                # enforce the planned output label set
                if set(result.labels) != set(step.out_labels):
                    raise AssertionError(
                        f"executor/planner divergence: {result.labels} "
                        f"vs {step.out_labels}")
            peak = max(peak, live + temp)
            for t, o in ((a, owned[step.i]), (b, owned[step.j])):
                if o:
                    live -= _nbytes(t.data)
            live += _nbytes(result.data)
            cur = rest + [result]
            owned = rest_owned + [True]
        if len(cur) != 1:
            raise AssertionError("plan did not reduce to one tensor")
        return cur[0], peak

    def _sliced_pair(self, a: Tensor, b: Tensor, out_labels, keep,
                     limit_elems: Optional[int], min_slices: int = 1,
                     devices=None) -> Tuple[Tensor, int]:
        """Slice the largest indices of a violating contraction, free
        (output) labels first, and stitch the partial results (over
        ``devices``, when given, in consecutive runs of slices, one
        partial output a distinct device, summed at the end). Returns the
        result and the step's tally (the partial outputs, one slab and its
        input copies)."""
        out_labels = list(out_labels)
        dims = {}
        dims.update({l: a.dim_of(l) for l in a.labels})
        dims.update({l: b.dim_of(l) for l in b.labels})
        out_elems = int(np.prod([dims[l] for l in out_labels], dtype=np.int64))

        def divisor_at_least(dim: int, need: int) -> int:
            need = min(max(1, need), dim)
            for c in range(need, dim + 1):
                if dim % c == 0:
                    return c
            return dim

        # choose (label, chunks) specs, largest index first, until EVERY
        # per-iteration slab — output AND both input copies — fits the
        # memory limit
        free_sorted = sorted(out_labels, key=lambda l: -dims[l])
        contracted_sorted = sorted(
            (l for l in dims if l not in set(out_labels)),
            key=lambda l: -dims[l])
        specs: List[Tuple[str, int]] = []
        chunks_of: Dict[str, int] = {}

        def next_divisor(dim: int, cur: int) -> Optional[int]:
            for c in range(cur + 1, dim + 1):
                if dim % c == 0:
                    return c
            return None

        def slab_of(ls) -> int:
            return int(np.prod([dims[l] // chunks_of.get(l, 1) for l in ls]
                               or [1], dtype=np.int64))

        if limit_elems is not None:
            if limit_elems < 1:
                raise MemoryError(
                    f"memory limit below one element ({out_elems}-element "
                    "output cannot fit)")
            while True:
                buffers = [bl for bl in (list(out_labels), a.labels, b.labels)
                           if slab_of(bl) > limit_elems]
                if not buffers:
                    break
                # grow the chunk count of the largest still-divisible label
                # present in an over-limit buffer (free labels preferred:
                # their slabs write disjoint regions, no accumulation)
                cands = [l for l in free_sorted + contracted_sorted
                         if any(l in bl for bl in buffers)
                         and dims[l] // chunks_of.get(l, 1) > 1]
                grown = False
                for l in cands:
                    c = next_divisor(dims[l], chunks_of.get(l, 1))
                    if c is not None:
                        chunks_of[l] = c
                        grown = True
                        break
                if not grown:
                    raise MemoryError(
                        f"contraction (inputs {slab_of(a.labels)}/"
                        f"{slab_of(b.labels)}, output {out_elems} elements) "
                        f"cannot be sliced under the memory limit "
                        f"({limit_elems} elements)")
            specs = [(l, chunks_of[l])
                     for l in free_sorted + contracted_sorted
                     if l in chunks_of]
        # honor a requested minimum slice count: free labels first, then
        # contracted labels, whose partial products accumulate into the
        # output (what makes a scalar output sliceable)
        total = int(np.prod([c for _, c in chunks_of.items()] or [1],
                            dtype=np.int64))
        if min_slices > 1:
            for l in free_sorted + contracted_sorted:
                if total >= min_slices:
                    break
                cur = chunks_of.get(l, 1)
                want = cur * (-(-min_slices // total))
                c = divisor_at_least(dims[l], min(want, dims[l]))
                if c > cur:
                    total = total // cur * c
                    chunks_of[l] = c
            specs = [(l, chunks_of[l])
                     for l in free_sorted + contracted_sorted
                     if l in chunks_of]
        if not specs:
            result = contract_pair(a, b, keep=keep)
            return result, _nbytes(result.data)

        csize = {l: dims[l] // c for l, c in specs}
        total = int(np.prod([c for _, c in specs], dtype=np.int64))
        self.last_num_slices = max(self.last_num_slices, total)

        a_labels, b_labels = list(a.labels), list(b.labels)
        out_shape = tuple(dims[l] for l in out_labels)
        dtype = torch.promote_types(a.data.dtype, b.data.dtype)
        accumulate = devices is not None or any(
            l not in set(out_labels) for l, _ in specs)
        home = a.data.device
        runs = {home: range(total)}
        if devices is not None:
            # consecutive runs of slices, one a mesh entry; the entries
            # that share a device (virtual shards) accumulate into one
            # partial output there
            per = -(-total // len(devices))
            runs = {}
            for i, d in enumerate(devices):
                runs.setdefault(torch.device(d), []).extend(
                    range(i * per, min((i + 1) * per, total)))
        slab_bytes = int(np.prod([csize.get(l, dims[l]) for l in out_labels],
                                 dtype=np.int64)) * dtype.itemsize
        copies = 0
        partials = []
        for dev, ks in runs.items():
            ad_full, bd_full = a.data.to(dev), b.data.to(dev)
            out = (torch.zeros if accumulate else torch.empty)(
                out_shape, dtype=dtype, device=dev)
            for k in ks:
                rem = k
                starts: Dict[str, int] = {}
                for l, c in reversed(specs):
                    starts[l] = (rem % c) * csize[l]
                    rem //= c
                ad, bd, region = ad_full, bd_full, out
                for l, _ in specs:
                    if l in a_labels:
                        ad = ad.narrow(a_labels.index(l), starts[l], csize[l])
                    if l in b_labels:
                        bd = bd.narrow(b_labels.index(l), starts[l], csize[l])
                    if l in out_labels:
                        region = region.narrow(out_labels.index(l), starts[l],
                                               csize[l])
                # a strided slab is copied once by the einsum
                copies = max(copies, sum(_nbytes(x) for x in (ad, bd)
                                         if not x.is_contiguous()))
                # sliced free labels stay as (chunk-sized) output axes, so
                # the slab has the out_labels axis order; sliced contracted
                # labels are summed inside the einsum (partial products)
                part = _einsum_pair(ad, a_labels, bd, b_labels, out_labels)
                if accumulate:
                    region.add_(part)
                else:
                    region.copy_(part)
                del part
            partials.append(out)
        # every partial output, plus one arriving on home at the sum
        held = sum(_nbytes(p) for p in partials)
        out = partials[0]
        if devices is not None:
            # free-sliced slabs land in disjoint zero regions and
            # contracted-sliced ones accumulate, so a plain sum merges both
            out = partials[0].to(home)
            away = [p for p in partials if p.device != home]
            if away:
                held += _nbytes(out)
            for p in partials[1:]:
                out.add_(p.to(home))
            sharded._count("all-reduce", sum(_nbytes(p) for p in away))
        return Tensor(out, tuple(out_labels)), held + slab_bytes + copies


def tensor_svd(tensor: Tensor, row_labels: Sequence[str],
               col_labels: Optional[Sequence[str]] = None,
               bond_label: str = "_s") -> Tuple[Tensor, Tensor, Tensor]:
    """Economy SVD A = U S V^H over a (row_labels | col_labels) bipartition
    (the reference's rocSOLVER gesvd 'S' mode as
    ``torch.linalg.svd(full_matrices=False)``, cuSOLVER's gesvd on the
    card)."""
    row_labels = list(row_labels)
    if col_labels is None:
        col_labels = [l for l in tensor.labels if l not in set(row_labels)]
    col_labels = list(col_labels)
    if set(row_labels) | set(col_labels) != set(tensor.labels) or \
            set(row_labels) & set(col_labels):
        raise ValueError("row/col labels must bipartition the tensor labels")

    perm = row_labels + col_labels
    data = tensor.data.permute([tensor.labels.index(l) for l in perm])
    m = int(np.prod([tensor.dim_of(l) for l in row_labels], dtype=np.int64))
    n = int(np.prod([tensor.dim_of(l) for l in col_labels], dtype=np.int64))
    # on the card: QR-based gesvd; torch's default Jacobi driver did not
    # reach float32 accuracy at 4096^2 in complex64 on an H100
    driver = "gesvd" if data.is_cuda else None
    u, s, vh = torch.linalg.svd(data.reshape(m, n), full_matrices=False,
                                driver=driver)
    k = min(m, n)
    u_t = Tensor(u.reshape(tuple(tensor.dim_of(l) for l in row_labels) + (k,)),
                 tuple(row_labels) + (bond_label,))
    s_t = Tensor(s, (bond_label,))
    v_t = Tensor(vh.reshape((k,) + tuple(tensor.dim_of(l) for l in col_labels)),
                 (bond_label,) + tuple(col_labels))
    return u_t, s_t, v_t
