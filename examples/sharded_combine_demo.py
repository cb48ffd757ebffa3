"""Multi-device sharded combine demo over every visible device.

The production layout: a 2-D (position, sample-row) jax.sharding.Mesh;
genome positions shard like the reference's MPI column partitions
(SURVEY.md 2.7) over one mesh axis, samples over the other, with
cross-sample reductions as all_gather collectives (NCCL on GPUs).  On
the CPU, XLA_FLAGS=--xla_force_host_platform_device_count=8 simulates
eight devices.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from genomicsdb_tpu.ops.combine_step import synthesize_cohort  # noqa: E402
from genomicsdb_tpu.parallel.sharded import (  # noqa: E402
    make_mesh, pad_block_for_mesh, shard_block, sharded_combine_step)


def main():
    print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")
    n_dev = len(jax.devices())
    n_row = 2 if n_dev % 2 == 0 else 1
    n_pos = n_dev // n_row
    mesh = make_mesh(n_pos, n_row)
    blk = synthesize_cohort(num_samples=8, cells_per_sample=64,
                            region_len=4096, seed=7)
    blk = pad_block_for_mesh(blk, n_pos, n_row)
    args = shard_block(mesh, blk)
    step = sharded_combine_step(mesh, max_merged=4, ploidy=2)
    out = step(*args)
    jax.block_until_ready(out)
    pl = np.asarray(out["pl"])
    dp = np.asarray(out["dp_info_sum"])
    print(f"mesh=({n_pos} pos x {n_row} row), "
          f"combined block: pl{list(pl.shape)}, "
          f"{int((dp > 0).sum())} records with INFO DP")


if __name__ == "__main__":
    main()
