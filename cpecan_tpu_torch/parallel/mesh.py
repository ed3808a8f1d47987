"""Device meshes and the process group of data-parallel runs.

Counterpart of cpecan_tpu/parallel/mesh.py. The port scales
data-parallel two ways, as the JAX package does:

 * a ``DataMesh`` inside one process: a 1-D tuple of torch devices over
   which ``ops/fb_batch.fb_pass_batch`` splits a batch into contiguous
   shards, one per device, and sums the expectation counts (the
   ``Mesh(devices, ("data",))`` + shard_map + psum of the JAX package);
 * several processes, each running the same program on its shard of the
   EM chunks (``process_shard``), whose counts are summed by one
   all-gather per iteration (``all_sum_across_processes``): the jobTree
   cluster scatter of cPecanEm (cPecanEm.py:166-188, 423).

The process group always uses gloo, on the card too: the only collective
is one all-gather of ~100 float64 numbers that already live on the host,
NCCL would buy nothing there, and NCCL refuses two ranks on one GPU.
Without a process group every helper is the single-process identity.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective (and the rendezvous) waits for the other ranks
# before it raises: torch's own default for gloo.
DEFAULT_TIMEOUT_S = 1800


class DataMesh(tuple):
    """A 1-D data-parallel mesh: a tuple of torch devices, which may
    repeat (two shards on one card)."""

    def __new__(cls, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a DataMesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a DataMesh's devices must share one type: "
                             f"{devices}")
        return super().__new__(cls, devices)

    @property
    def size(self) -> int:
        return len(self)

    @property
    def devices(self) -> tuple:
        return tuple(self)


def data_mesh(n_devices: int | None = None, device="cuda") -> DataMesh:
    """1-D mesh over the first n_devices local CUDA devices (all of them by
    default), or over n_devices copies of the CPU (one by default) for
    ``device="cpu"``. Asking for more CUDA devices than exist raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return DataMesh([torch.device("cpu")] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"no data mesh over {kind!r} devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("a CUDA data mesh was requested but no CUDA "
                           "device is available")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} CUDA devices was requested; "
                         f"{count} are available")
    return DataMesh([torch.device("cuda", i) for i in range(n)])


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the gloo process group of a multi-process run (a no-op for
    one process). Every process runs the same program with its own
    process_id; the process with id 0 serves the rendezvous at
    coordinator_address (host:port). ``timeout_s`` bounds the rendezvous
    and every collective, so a rank whose peer died raises instead of
    waiting for ever."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address host:port")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_up() else 1


def process_shard(items: list) -> list:
    """This process's shard of a work list that is the same in every
    process: items[rank::world] (cPecanEm.py:166-171's scatter)."""
    return list(items)[process_index()::process_count()]


def all_sum_across_processes(arrays: list) -> list:
    """Element-wise float64 sum of per-process arrays over all processes
    (the expectation-count reduction, cPecanEm.py:184-188). One gloo
    all-gather, then a sum in rank order on the host, so every process
    gets the same bits (an all-reduce sums in the backend's order). One
    process: float64 copies."""
    if process_count() == 1:
        return [np.asarray(a, np.float64) for a in arrays]
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float64).ravel() for a in arrays]))
    gathered = [torch.empty_like(flat) for _ in range(process_count())]
    dist.all_gather(gathered, flat)
    total = np.stack([g.numpy() for g in gathered]).sum(axis=0)
    out, pos = [], 0
    for a in arrays:
        a = np.asarray(a)
        out.append(total[pos:pos + a.size].reshape(a.shape))
        pos += a.size
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
