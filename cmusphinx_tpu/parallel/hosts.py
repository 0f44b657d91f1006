"""Multi-host entry point + corpus partitioning.

The reference distributes training by launching N independent `bw -part i
-npart N` processes (SphinxTrain bw/main.c:492-497 corpus_set_partition)
from a Perl job queue (scripts_pl/lib/Queue/{POSIX,PBS}.pm) and reducing
accumulator FILES with `norm`.  The equivalent here is one SPMD program:
`jax.distributed.initialize()` joins the hosts, each host loads its ctl
partition (the -part/-npart contract, re-used verbatim), devices form one
global `jax.sharding.Mesh`, and the reduce is a `psum` over the device
links within a host and the network across hosts — `norm`-over-NFS
becomes a collective.

Single-host fallback: with no coordinator configured (and no multi-host
environment detected) `init_distributed` is a no-op returning process
0-of-1, so every entry point works unchanged on one machine — the analog
of running NPART forked jobs on one box (Queue/POSIX.pm), which is also
how this path is validated here: the dryrun partitions a corpus with
`partition_ctl`, accumulates each part separately on a virtual-device
mesh, and checks the psum'd result equals the single-pass accumulators.

What real N-host validation still needs (not available in this
environment): N processes each seeing only its local devices, started
with matching `--coordinator host:port --num-processes N --process-id i`,
and a shared filesystem or object store
for checkpoints.  The code path below is exactly what those processes
would run; only the transport (DCN) is unexercised.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass
class HostInfo:
    process_id: int
    num_processes: int
    initialized: bool   # True when jax.distributed actually initialized

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> HostInfo:
    """Join (or skip) the multi-host runtime.

    Explicit args win; otherwise standard env vars are consulted
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns the host's identity; on a
    single host this is a documented no-op (process 0 of 1).
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator is None and (num_processes is None
                                or num_processes <= 1):
        return HostInfo(process_id=0, num_processes=1, initialized=False)

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return HostInfo(process_id=jax.process_index(),
                    num_processes=jax.process_count(), initialized=True)


def partition_ctl(items: Sequence, part: int, npart: int) -> List:
    """The bw/sphinx3 `-part i -npart N` ctl split (corpus.c
    corpus_set_partition: contiguous blocks, remainder spread over the
    first parts; 1-based part ids like the reference flags)."""
    if not (1 <= part <= npart):
        raise ValueError(f"part must be in [1, {npart}], got {part}")
    n = len(items)
    base, rem = divmod(n, npart)
    sizes = [base + (1 if i < rem else 0) for i in range(npart)]
    lo = sum(sizes[: part - 1])
    return list(items[lo : lo + sizes[part - 1]])


def local_partition(items: Sequence, info: Optional[HostInfo] = None) -> List:
    """This host's share of a work list (per-host data loading for the
    global mesh: host i loads partition i+1 of N)."""
    if info is None:
        import jax
        info = HostInfo(jax.process_index(), jax.process_count(), True)
    return partition_ctl(items, info.process_id + 1, info.num_processes)
