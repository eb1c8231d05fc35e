"""Worker for the real 2-process jax.distributed test.

Usage: python tests/_dist_worker.py <pid> <nproc> <port> <prefix> <fasta>

Initializes jax.distributed against a local coordinator, processes this
process's read shard with run_file_sharded, then all-gathers each
process's record count across processes (the SURVEY 2.13 communication
pattern: fixed-width data over the collective backend).
"""

import os
import sys


def main() -> int:
    pid, n = int(sys.argv[1]), int(sys.argv[2])
    port, prefix, fasta = sys.argv[3], sys.argv[4], sys.argv[5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n,
        process_id=pid,
    )
    assert jax.process_count() == n, jax.process_count()

    from mtr.config import MTRConfig
    from mtr.parallel.distributed import run_file_sharded

    run_file_sharded(
        fasta, prefix, MTRConfig(backend="host"),
        process_index=jax.process_index(),
        process_count=jax.process_count(),
    )

    import numpy as np
    from jax.experimental import multihost_utils

    n_lines = sum(1 for _ in open(f"{prefix}.part{pid}"))
    gathered = multihost_utils.process_allgather(
        np.array([n_lines], np.int32))
    np.save(f"{prefix}.gather{pid}.npy", np.asarray(gathered).reshape(-1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
