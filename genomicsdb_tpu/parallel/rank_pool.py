"""Pre-forked persistent rank-worker pool.

The reference's execution model launches one MPI rank process per
column partition PER JOB (`mpirun vcf2tiledb` / `gt_mpi_gather`,
tools/src/vcf2tiledb.cc:44-52, gt_mpi_gather.cc:166-295), so every job
pays interpreter + runtime startup in every rank.  In a serving
deployment the partitions are long-lived; this pool forks the rank
workers ONCE — before any XLA client exists, so the fork is safe and
each child initializes its own backend — and then serves partition
queries over length-framed pipes.  A query against a warm pool costs
compute + gather only, which is what converts the rank-scaling wall
efficiency from startup-bound (~63% at 4 ranks) to compute-bound
(tools/scaling_bench.py measures both models).

Workers run `tools.gdb_query` single-rank queries (`rank_output`), so
pool results are byte-identical to spawned `gdb_query --rank r` output
by construction; the root process gathers pieces in rank order (the
MPI_Gatherv root, gt_mpi_gather.cc:166-263).
"""

from __future__ import annotations

import json
import os
import struct
import sys
import traceback
from typing import List, Optional

_HDR = struct.Struct("<Q")


def _send(fd: int, payload: bytes):
    os.write(fd, _HDR.pack(len(payload)))
    off = 0
    while off < len(payload):
        off += os.write(fd, payload[off:off + (1 << 20)])


def _recv(fd: int) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < _HDR.size:
        got = os.read(fd, _HDR.size - len(hdr))
        if not got:
            return None
        hdr += got
    (n,) = _HDR.unpack(hdr)
    chunks = []
    left = n
    while left:
        got = os.read(fd, min(left, 1 << 20))
        if not got:
            return None
        chunks.append(got)
        left -= len(got)
    return b"".join(chunks)


def _worker_loop(req_fd: int, res_fd: int):
    from ..tools import gdb_query
    while True:
        frame = _recv(req_fd)
        if frame is None or frame == b"\0shutdown":
            return
        try:
            argv = json.loads(frame)
            out = gdb_query.rank_output(argv).encode()
            _send(res_fd, b"OK\0" + out)
        except BaseException:
            _send(res_fd, b"ER\0" + traceback.format_exc().encode())


class RankPool:
    """K pre-forked, optionally core-pinned rank workers.

    Fork happens in __init__ and MUST precede any XLA backend
    initialization in the calling process (jax module imports are fine;
    a live client's threads are not) — each worker initializes its own
    backend on first use, with its share of the card's memory
    (runtime/device_env.rank_env)."""

    def __init__(self, num_ranks: int, pin_cores: bool = True):
        if not hasattr(os, "fork"):
            raise RuntimeError("RankPool requires os.fork")
        # pre-import the worker's modules once: children share them COW
        from ..runtime.device_env import rank_env
        from ..tools import gdb_query  # noqa: F401
        ncores = os.cpu_count() or 1
        self._workers = []
        for i in range(num_ranks):
            req_r, req_w = os.pipe()
            res_r, res_w = os.pipe()
            pid = os.fork()
            if pid == 0:                       # child
                os.close(req_w)
                os.close(res_r)
                code = 0
                try:
                    # this worker's share of the card (device_env)
                    os.environ.update(rank_env(i, num_ranks, base={}))
                    if pin_cores and hasattr(os, "sched_setaffinity"):
                        os.sched_setaffinity(0, {i % ncores})
                    _worker_loop(req_r, res_w)
                except BaseException:
                    traceback.print_exc(file=sys.stderr)
                    code = 1
                finally:
                    os._exit(code)
            os.close(req_r)
            os.close(res_w)
            self._workers.append((pid, req_w, res_r))

    def __len__(self):
        return len(self._workers)

    def run(self, argvs: List[List[str]]) -> List[str]:
        """Dispatch one gdb_query argv per worker (argvs[i] -> worker
        i); gather outputs in rank order.  len(argvs) must not exceed
        the pool size; extra workers idle."""
        assert len(argvs) <= len(self._workers)
        for (pid, w, r), argv in zip(self._workers, argvs):
            _send(w, json.dumps(argv).encode())
        outs: List[str] = []
        errs: List[str] = []
        for i, ((pid, w, r), _argv) in enumerate(
                zip(self._workers, argvs)):
            got = _recv(r)
            if got is None:
                errs.append(f"rank worker {i} died")
                outs.append("")
            elif got[:3] == b"OK\0":
                outs.append(got[3:].decode())
            else:
                errs.append(f"rank worker {i}:\n"
                            + got[3:].decode(errors="replace"))
                outs.append("")
        if errs:
            raise RuntimeError("rank pool query failed:\n"
                               + "\n".join(errs))
        return outs

    def close(self):
        for pid, w, r in self._workers:
            try:
                _send(w, b"\0shutdown")
            except OSError:
                pass
            try:
                os.close(w)
                os.close(r)
            except OSError:
                pass
        for pid, _w, _r in self._workers:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        self._workers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
