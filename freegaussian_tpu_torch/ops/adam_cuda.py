"""Adam's update of every optimizer group in one pass: the CUDA kernel's
wrapper (`csrc/adam.cu`) and its plain PyTorch version.

`adam_step(groups, alive)` runs one Adam step of each `AdamGroup`, in
place on its parameters and moments, with optax's arithmetic operation for
operation (`engine/optimizers.py`). A group marked `masked` holds Gaussian
slots: the gradient of a slot that `alive` marks dead counts as +0 (a
select, so a NaN or inf there is dropped). A missing gradient (None) counts
as zeros. A group's step scalars (-lr, 1 / (1 - b1^t), 1 / (1 - b2^t)) are
f32 values (`optimizers.adam_scalars`) or a (3,) f32 row on the tensors'
device, which a CUDA graph reads at each replay; both give the same bits.

On CPU tensors it runs the plain version: per tensor, a `torch.where` on the
dead slots and a chain of elementwise operations. On CUDA tensors it checks
the table (f32, contiguous, one device, shapes; a masked group's gradient
may instead hold each slot's row contiguous, rows apart by a stride, as the
SH coefficients' gradients do) and launches the kernel, one
launch for up to MAX_TENSORS tensors and MAX_GROUPS groups (the table rides
in the kernel's parameters, within their 4 KB), or raises; it never falls
back to the plain version. The kernel rounds every product and sum as the
plain version's separate kernels do, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MAX_TENSORS = 48  # csrc/adam.cu's kMaxTensors: tensors of one launch's table
MAX_GROUPS = 16  # kMaxGroups: groups of one launch's table
CHUNK = 4096  # kChunk: elements of one work item
MAX_NUMEL = 2**31 - 1  # the kernel indexes a tensor's elements in 32 bits

# Kernel launches by kernel name; the wrapper adds one where it launches.
LAUNCHES = {"adam": 0}
# The CUDA sources (csrc/<name>.cu) this module launches.
KERNEL_SOURCES = ("adam",)

Scalars = Union[Tuple[float, float, float], torch.Tensor]


@dataclasses.dataclass
class AdamGroup:
    """One group's step: its Adam constants, its step scalars, and its
    tensors as (param, grad or None, mu, nu)."""

    b1: float
    b2: float
    eps: float
    scalars: Scalars
    tensors: List[Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]]
    masked: bool = False  # rows are Gaussian slots, masked by `alive`


class Launch(NamedTuple):
    """One launch of the kernel: the table's tensors and groups (indices into
    the flattened tensors and the groups) and each tensor's first work item,
    the last entry the items of the launch."""

    tensors: Tuple[int, ...]
    groups: Tuple[int, ...]
    chunk_start: Tuple[int, ...]


def launch_plan(numels: Sequence[int], group_of: Sequence[int], max_tensors: int = MAX_TENSORS,
                max_groups: int = MAX_GROUPS) -> List[Launch]:
    """The table split into launches, in order: a launch takes tensors until
    it holds `max_tensors` of them or the next would bring a group beyond
    `max_groups`. Empty tensors are left out."""
    launches: List[Launch] = []
    tensors: List[int] = []
    groups: List[int] = []

    def close():
        starts = [0]
        for i in tensors:
            starts.append(starts[-1] + -(-numels[i] // CHUNK))
        launches.append(Launch(tuple(tensors), tuple(groups), tuple(starts)))

    for i, (n, gi) in enumerate(zip(numels, group_of)):
        if n == 0:
            continue
        if len(tensors) == max_tensors or (gi not in groups and len(groups) == max_groups):
            close()
            tensors, groups = [], []
        tensors.append(i)
        if gi not in groups:
            groups.append(gi)
    if tensors:
        close()
    return launches


def row_width(t: torch.Tensor, capacity: int) -> int:
    """Elements of one slot of a Gaussian tensor (capacity, ...)."""
    return t.numel() // capacity if capacity else 0


def row_stride(g: torch.Tensor) -> Optional[int]:
    """0 for a contiguous gradient; for one whose slot rows are each
    contiguous and lie apart (a slice of a wider gradient), the elements
    from one row to the next; None for any other layout."""
    if g.is_contiguous():
        return 0
    if g.ndim >= 1 and g[0].is_contiguous() and g.stride(0) >= g[0].numel():
        return g.stride(0)
    return None


def adam_plain(groups: Sequence[AdamGroup], alive: Optional[torch.Tensor]) -> None:
    """The plain version: per tensor, the dead slots' gradient replaced by
    zeros with `torch.where`, then optax's update as separate elementwise
    operations."""
    for grp in groups:
        if isinstance(grp.scalars, torch.Tensor):
            neg_lr, inv_bc1, inv_bc2 = grp.scalars[0], grp.scalars[1], grp.scalars[2]
        else:
            neg_lr, inv_bc1, inv_bc2 = grp.scalars
        for p, g, mu, nu in grp.tensors:
            if g is None:
                g = torch.zeros_like(p)
            elif grp.masked and alive is not None:
                g = torch.where(alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, torch.zeros_like(g))
            mu.mul_(grp.b1).add_(g * (1 - grp.b1))
            nu.mul_(grp.b2).add_((g * g) * (1 - grp.b2))
            update = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + grp.eps)
            p.add_(update * neg_lr)


def check_table(groups: Sequence[AdamGroup], alive: Optional[torch.Tensor]) -> torch.device:
    """The kernel's conditions on its table; returns the tensors' device.
    Raises ValueError on a tensor that is not f32 or not contiguous (a
    masked group's gradient: nor in contiguous slot rows, `row_stride`), on
    another device, or shaped unlike its parameter, and on a mask that does
    not fit the masked groups' rows."""
    dev = groups[0].tensors[0][0].device

    def check(name, t, shape, rows=False):
        if t.device != dev:
            raise ValueError(f"adam: {name} is on {t.device}, the parameters on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"adam: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous() and not (rows and row_stride(t) is not None):
            raise ValueError(f"adam: {name} is not contiguous" + (" nor in contiguous slot rows" if rows else ""))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"adam: {name} has shape {tuple(t.shape)}, the parameter {tuple(shape)}")

    if any(grp.masked for grp in groups):
        if alive is None or alive.dtype != torch.bool or alive.ndim != 1 or not alive.is_contiguous():
            raise ValueError("adam: a masked group needs `alive`, a contiguous (capacity,) bool tensor")
        if alive.device != dev:
            raise ValueError(f"adam: alive is on {alive.device}, the parameters on {dev}")
    for gi, grp in enumerate(groups):
        if isinstance(grp.scalars, torch.Tensor):
            check(f"group {gi}'s scalars", grp.scalars, (3,))
        for ti, (p, g, mu, nu) in enumerate(grp.tensors):
            check(f"group {gi} tensor {ti}'s parameter", p, p.shape)
            if p.numel() > MAX_NUMEL:
                raise ValueError(f"adam: group {gi} tensor {ti} has {p.numel()} elements, above {MAX_NUMEL}")
            for name, t in (("gradient", g), ("mu", mu), ("nu", nu)):
                if t is not None:
                    check(f"group {gi} tensor {ti}'s {name}", t, p.shape, rows=grp.masked and name == "gradient")
            if grp.masked and (p.ndim == 0 or p.shape[0] != alive.shape[0]):
                raise ValueError(f"adam: group {gi} tensor {ti} has {tuple(p.shape)}, not {alive.shape[0]} slots")
    return dev


def adam_step(groups: Sequence[AdamGroup], alive: Optional[torch.Tensor] = None) -> None:
    """One Adam step of every group, in place (see the module's docstring)."""
    groups = [grp for grp in groups if grp.tensors]
    if not groups:
        return
    dev = groups[0].tensors[0][0].device
    if dev.type == "cpu":
        adam_plain(groups, alive)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam runs on cuda or cpu tensors, got {dev}")
    check_table(groups, alive)
    fn, err = _kernel()
    flat = [(gi, t) for gi, grp in enumerate(groups) for t in grp.tensors]
    capacity = alive.shape[0] if alive is not None else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in launch_plan([t[0].numel() for _, t in flat], [gi for gi, _ in flat]):
        table = _table(groups, flat, launch, alive, capacity)
        rc = fn(ctypes.byref(table), stream)
        if rc != 0:
            raise RuntimeError(f"adam launch failed: {err(rc).decode()} (cudaError {rc})")
        LAUNCHES["adam"] += 1


# ---------------------------------------------------------------------------
# the kernel's table
# ---------------------------------------------------------------------------


class _Group(ctypes.Structure):
    _fields_ = [("scalars", ctypes.c_void_p)] + [
        (name, ctypes.c_float) for name in ("neg_lr", "inv_bc1", "inv_bc2", "b1", "c1", "b2", "c2", "eps")
    ]


class _Table(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_void_p * MAX_TENSORS),
        ("g", ctypes.c_void_p * MAX_TENSORS),
        ("mu", ctypes.c_void_p * MAX_TENSORS),
        ("nu", ctypes.c_void_p * MAX_TENSORS),
        ("alive", ctypes.c_void_p),
        ("numel", ctypes.c_int * MAX_TENSORS),
        ("row_width", ctypes.c_int * MAX_TENSORS),
        ("g_stride", ctypes.c_int * MAX_TENSORS),
        ("group", ctypes.c_int * MAX_TENSORS),
        ("chunk_start", ctypes.c_int * (MAX_TENSORS + 1)),
        ("num_tensors", ctypes.c_int),
        ("groups", _Group * MAX_GROUPS),
    ]


def _table(groups, flat, launch: Launch, alive, capacity: int) -> _Table:
    """The kernel's parameters for `launch`. The constants are the f32
    values the plain version's operations take: b1, 1 - b1 in double then
    rounded, b2, 1 - b2, eps."""
    f32 = lambda x: float(np.float32(x))
    t = _Table()
    t.alive = alive.data_ptr() if alive is not None else None
    t.num_tensors = len(launch.tensors)
    for j, gi in enumerate(launch.groups):
        grp, row = groups[gi], t.groups[j]
        row.b1, row.c1, row.b2, row.c2, row.eps = (f32(v) for v in (grp.b1, 1 - grp.b1, grp.b2, 1 - grp.b2, grp.eps))
        if isinstance(grp.scalars, torch.Tensor):
            row.scalars = grp.scalars.data_ptr()
        else:
            row.neg_lr, row.inv_bc1, row.inv_bc2 = (f32(v) for v in grp.scalars)
    for j, i in enumerate(launch.tensors):
        gi, (p, g, mu, nu) = flat[i]
        t.p[j], t.mu[j], t.nu[j] = p.data_ptr(), mu.data_ptr(), nu.data_ptr()
        t.g[j] = g.data_ptr() if g is not None else None
        t.numel[j] = p.numel()
        t.row_width[j] = row_width(p, capacity) if groups[gi].masked else 0
        t.g_stride[j] = row_stride(g) if g is not None and groups[gi].masked else 0
        t.group[j] = launch.groups.index(gi)
    for j, s in enumerate(launch.chunk_start):
        t.chunk_start[j] = s
    return t


_fns: dict = {}


def _kernel():
    """(entry point, error-string function) of `csrc/adam.cu`."""
    if "adam" not in _fns:
        from ..cuda_build import load

        lib = load("adam")
        for name, want in (("adam_table_bytes", ctypes.sizeof(_Table)), ("adam_max_tensors", MAX_TENSORS),
                           ("adam_max_groups", MAX_GROUPS), ("adam_chunk", CHUNK)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"adam.cu's {name} is {fn()}, this module's {want}")
        fn = lib.adam_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.adam_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns["adam"] = (fn, err)
    return _fns["adam"]
