"""Adam's one-pass kernel (`csrc/adam.cu`) against its plain version
(`ops/adam_cuda.py:adam_plain`, the chain of PyTorch elementwise kernels), on
a GPU, bit for bit: p, mu and nu after each step.

Cases: the Gaussian tensors' shapes (n,), (n, 3), (n, 4), (n, 15, 3) and
the fields' weight shapes, at n = 1, 127, 4,099 and 2^19, with a holed alive
mask and NaN and inf in dead rows' gradients, the (n, 3) and (n, 15, 3)
gradients slices of one (n, 16, 3) gradient (read by row stride, as the
step's SH gradients are); a missing gradient; a tensor
whose address is not 16-byte aligned (the kernel's scalar path); several
groups in one launch; one table split over two launches; 3 replays of a
captured CUDA graph reading changing scalar rows, equal to 3 eager steps
with the same scalars as host values; the argument checks.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without a card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adam_cuda.py
"""

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.ops import adam_cuda
from freegaussian_tpu_torch.ops.adam_cuda import AdamGroup, adam_plain, adam_step

GAUSSIAN_SHAPES = [(), (3,), (4,), (15, 3)]
FIELD_SHAPES = [(256, 93), (256,), (256, 256), (30, 256), (3, 256), (13,)]
SCALARS = [(-8.0e-4, 1.8, 37.0), (-7.5e-4, 1.6, 19.0), (-7.0e-4, 1.4, 13.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _state(dev, n, seed, misaligned=False):
    """Seeded tensors and gradients: the Gaussian group at n slots with NaN
    and inf in dead rows, and a field group with one missing gradient (and,
    when `misaligned`, one tensor at an odd float offset)."""
    rng = np.random.default_rng(seed)
    t = lambda shape, scale=1.0: torch.tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32, device=dev)
    alive = torch.tensor(rng.uniform(size=n) < 0.6, device=dev)
    alive[-(n // 3):] = False
    dead = torch.nonzero(~alive)[:, 0]

    def tensors(shape, grad=True, masked=False):
        p, g, mu, nu = t(shape), t(shape, 1e-2), t(shape, 1e-2), t(shape, 1e-4).abs()
        if masked and dead.numel():
            g[dead[::2]] = float("nan")
            g[dead[1::2]] = float("inf")
        return [p, g if grad else None, mu, nu]

    gaussians = [tensors((n,) + s, masked=True) for s in GAUSSIAN_SHAPES]
    # the SH coefficients' gradients as the step gets them: slices of one (n, 16, 3) gradient
    sh = torch.empty((n, 16, 3), device=dev)
    sh[:, 0, :], sh[:, 1:, :] = gaussians[1][1], gaussians[3][1]
    gaussians[1][1], gaussians[3][1] = sh[:, 0, :], sh[:, 1:, :]
    field = [tensors(s, grad=i != 1) for i, s in enumerate(FIELD_SHAPES)]
    if misaligned:
        numel = 999
        bufs = [torch.zeros(numel + 1, device=dev) for _ in range(4)]
        views = [b[1:].view(27, 37) for b in bufs]
        for v, src in zip(views, tensors((27, 37))):
            v.copy_(src)
        assert views[0].data_ptr() % 16 != 0
        field.append(views)
    return alive, [gaussians, field]


def _groups(state, scalars):
    gaussians, field = state
    return [
        AdamGroup(0.9, 0.999, 1e-15, scalars[0], [tuple(x) for x in gaussians], masked=True),
        AdamGroup(0.9, 0.999, 1e-15, scalars[1], [tuple(x) for x in field]),
    ]


def _clone(state):
    return [[[x.clone() if x is not None else None for x in ts] for ts in grp] for grp in state]


def _assert_bit_equal(a, b):
    for grp_a, grp_b in zip(a, b):
        for ts_a, ts_b in zip(grp_a, grp_b):
            for name, x, y in zip(("p", "g", "mu", "nu"), ts_a, ts_b):
                if name != "g":
                    assert torch.equal(_bits(x), _bits(y)), (name, tuple(x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4099, 2**19])
def test_kernel_equals_the_plain_chain(dev, n):
    alive, kernel = _state(dev, n, seed=n, misaligned=n == 4099)
    plain = _clone(kernel)
    launches = adam_cuda.LAUNCHES["adam"]
    for step in range(2):
        adam_step(_groups(kernel, SCALARS[step : step + 2]), alive)
        adam_plain(_groups(plain, SCALARS[step : step + 2]), alive)
    torch.cuda.synchronize()
    assert adam_cuda.LAUNCHES["adam"] == launches + 2  # every group and tensor in one launch a step
    _assert_bit_equal(kernel, plain)
    for ts in kernel[0]:
        assert torch.isfinite(ts[0]).all() and torch.isfinite(ts[2]).all()


@pytest.mark.cuda
def test_a_table_split_over_two_launches(dev, monkeypatch):
    plan = adam_cuda.launch_plan
    monkeypatch.setattr(adam_cuda, "launch_plan", lambda numels, groups: plan(numels, groups, max_tensors=6))
    alive, kernel = _state(dev, 4099, seed=5)
    plain = _clone(kernel)
    launches = adam_cuda.LAUNCHES["adam"]
    adam_step(_groups(kernel, SCALARS), alive)
    adam_plain(_groups(plain, SCALARS), alive)
    torch.cuda.synchronize()
    assert adam_cuda.LAUNCHES["adam"] == launches + 2  # 10 tensors, 6 a launch
    _assert_bit_equal(kernel, plain)


@pytest.mark.cuda
def test_graph_replays_read_the_scalar_rows(dev):
    """Three replays of one captured step, each reading the step's row of a
    device table, against three eager steps given the same scalars as host
    values and, through device rows, eagerly."""
    alive, graphed = _state(dev, 4099, seed=9)
    eager, rows_eager = _clone(graphed), _clone(graphed)
    table = torch.tensor([[SCALARS[j], SCALARS[j + 1] if j + 1 < 3 else SCALARS[0]] for j in range(3)], device=dev)
    row = torch.zeros_like(table[0])
    warm_alive, warm = _state(dev, 5, seed=1)
    adam_step(_groups(warm, SCALARS), warm_alive)  # builds and loads the kernel outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        adam_step(_groups(graphed, [row[0], row[1]]), alive)
    for j in range(3):
        row.copy_(table[j])
        graph.replay()
        host = [tuple(float(v) for v in table[j, i].tolist()) for i in range(2)]
        adam_step(_groups(eager, host), alive)
        adam_step(_groups(rows_eager, [table[j, 0], table[j, 1]]), alive)
    torch.cuda.synchronize()
    _assert_bit_equal(graphed, eager)
    _assert_bit_equal(rows_eager, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["noncontiguous", "bf16", "cpu_grad", "no_alive"])
def test_argument_checks_raise(dev, case):
    alive, state = _state(dev, 127, seed=3)
    p, g, mu, nu = state[0][1]
    if case == "noncontiguous":
        state[0][1] = [p, torch.zeros(3, 127, device=dev).t(), mu, nu]
    elif case == "bf16":
        state[0][1] = [p, g.bfloat16(), mu, nu]
    elif case == "cpu_grad":
        state[0][1] = [p, g.cpu(), mu, nu]
    launches = adam_cuda.LAUNCHES["adam"]
    with pytest.raises(ValueError, match="adam"):
        adam_step(_groups(state, SCALARS), None if case == "no_alive" else alive)
    assert adam_cuda.LAUNCHES["adam"] == launches
