"""Process-isolated local Spark runner (the pyspark RDD API subset the
integration uses).

pyspark is not bundled in every deployment, but the Spark wiring
(spark_api.build_rdd and its executor closures) must still EXECUTE —
not just typecheck.  LocalSparkContext runs each RDD partition in a
separate worker PROCESS with the task closure and items shipped by
pickle, reproducing the two properties of a real Spark local[N] master
that matter for integration faithfulness:

  * closures and their captured configs must survive serialization to
    an executor that shares no interpreter state, and
  * partitions evaluate independently and results gather in partition
    order (GenomicsDBRDD's semantics over GenomicsDBInputFormat splits,
    src/main/scala/com/intel/genomicsdb/GenomicsDBRDD.scala:24-49).

The API subset mirrors pyspark exactly (parallelize / map / flatMap /
mapPartitions / collect / count / getNumPartitions), so the same
build_rdd call runs unchanged against a real SparkContext when pyspark
is available.
"""

from __future__ import annotations

try:
    # pyspark serializes task closures with cloudpickle: lambdas and
    # local functions must work; mirror that when it is available
    import cloudpickle as pickle
except ImportError:              # pragma: no cover - always bundled
    import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Sequence

_OPS = ("map", "flatMap", "mapPartitions", "mapPartitionsWithIndex",
        "filter", "glom")


def _run_partition(payload: bytes) -> bytes:
    """Executor entry: unpickle (partition idx, items, op chain),
    evaluate, pickle results back.  Runs in a fresh worker process."""
    pidx, items, chain = pickle.loads(payload)
    for op, fn in chain:
        if op == "map":
            items = [fn(x) for x in items]
        elif op == "flatMap":
            items = [y for x in items for y in fn(x)]
        elif op == "mapPartitions":
            items = list(fn(iter(items)))
        elif op == "mapPartitionsWithIndex":
            items = list(fn(pidx, iter(items)))
        elif op == "filter":
            items = [x for x in items if fn(x)]
        elif op == "glom":
            items = [items]
        else:
            raise ValueError(op)
    return pickle.dumps(items)


def _init_worker(counter, n_workers: int):
    """Executor start-up: take this worker's share of the card's memory
    (runtime/device_env.rank_env) before anything opens a device."""
    import os

    from ..runtime.device_env import rank_env
    with counter.get_lock():
        index = counter.value
        counter.value += 1
    os.environ.update(rank_env(index, n_workers, base={}))


class LocalRDD:
    def __init__(self, ctx: "LocalSparkContext",
                 partitions: List[list], chain=()):
        self._ctx = ctx
        self._parts = partitions
        self._chain = tuple(chain)

    def _with(self, op: str, fn: Callable) -> "LocalRDD":
        assert op in _OPS
        return LocalRDD(self._ctx, self._parts,
                        self._chain + ((op, fn),))

    def map(self, fn):
        return self._with("map", fn)

    def flatMap(self, fn):
        return self._with("flatMap", fn)

    def mapPartitions(self, fn):
        return self._with("mapPartitions", fn)

    def mapPartitionsWithIndex(self, fn):
        return self._with("mapPartitionsWithIndex", fn)

    def filter(self, fn):
        return self._with("filter", fn)

    def glom(self):
        return self._with("glom", lambda x: x)

    def getNumPartitions(self) -> int:
        return len(self._parts)

    def collect(self) -> list:
        payloads = [pickle.dumps((i, p, self._chain))
                    for i, p in enumerate(self._parts)]
        results = list(self._ctx._pool_map(_run_partition, payloads))
        out: list = []
        for blob in results:
            out.extend(pickle.loads(blob))
        return out

    def count(self) -> int:
        return len(self.collect())

    def take(self, n: int) -> list:
        return self.collect()[:n]

    def first(self):
        got = self.take(1)
        if not got:
            raise ValueError("RDD is empty")
        return got[0]


class LocalSparkContext:
    """local[N]-style context: N worker processes, partition-ordered
    collect."""

    def __init__(self, parallelism: int = 2):
        self.defaultParallelism = parallelism

    def _pool_map(self, fn, payloads: Sequence[bytes]):
        # spawn fresh interpreters: no inherited module state, like
        # real executors (fork would silently share this process's
        # imports and hide pickling bugs)
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        counter = ctx.Value("i", 0)
        with ProcessPoolExecutor(max_workers=self.defaultParallelism,
                                 mp_context=ctx, initializer=_init_worker,
                                 initargs=(counter,
                                           self.defaultParallelism)
                                 ) as pool:
            return list(pool.map(fn, payloads))

    def parallelize(self, data, numSlices: int = 0) -> LocalRDD:
        data = list(data)
        n = max(1, numSlices or self.defaultParallelism)
        n = min(n, max(len(data), 1))
        per = (len(data) + n - 1) // n
        parts = [data[i * per:(i + 1) * per] for i in range(n)]
        return LocalRDD(self, [p for p in parts if p] or [[]])

    def stop(self):
        pass
