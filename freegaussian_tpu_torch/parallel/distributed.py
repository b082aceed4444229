"""Process-group set-up and the differentiable all-gather (twin of
`freegaussian_tpu/parallel/distributed.py`).

One process per GPU, as `torchrun` starts them (it sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT): `ensure_distributed` joins the
process group, over NCCL on the card and over gloo when the caller asks
for the CPU. With one process and no address it is a no-op, as the JAX
package's is.

`all_gather_rows` is the gather of the primitive-sharded pixel stage
(`ops/rasterize.py`'s `gather_axis`): torch.distributed collectives do not
differentiate, so its backward is written out, the reduce-scatter that is
the transpose of the all-gather.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def ensure_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
) -> Tuple[int, int]:
    """Join the process group if needed; returns (rank, world size).
    `init_method` (e.g. "tcp://localhost:29500"), `world_size` and `rank`
    default to torchrun's environment. On the card the process takes GPU
    LOCAL_RANK and the NCCL backend; with device "cpu", gloo."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
        if world_size > 1 or init_method is not None:
            rank = int(os.environ.get("RANK", 0)) if rank is None else rank
            kw = {}
            if dev.type == "cuda":
                local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
                torch.cuda.set_device(local)
                kw["device_id"] = torch.device("cuda", local)
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=init_method or "env://", world_size=world_size, rank=rank, **kw,
            )
    return host_shard_info()


def host_shard_info() -> Tuple[int, int]:
    """(shard index, shard count) of this process's share of the frames."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device_count() -> int:
    """The GPUs this host sees (1 without one: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's shards of `x` stacked along dim 0, in group-rank order.
    Differentiable: the gradient of each rank's shard is the sum over the
    group of the gathered gradient's rows of that shard."""
    return _AllGatherRows.apply(x, group)
