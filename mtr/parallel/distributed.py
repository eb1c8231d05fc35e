"""Multi-host orchestration.

Reads are embarrassingly parallel, so the multi-host strategy is plain
data parallelism with deterministic output order:

  * every process streams the same FASTA and processes reads whose index
    satisfies idx % process_count == process_index (round-robin keeps
    per-host load balanced across length distributions);
  * the arena-reuse quirks (stale buffer contents) are PER-PROCESS in
    the reference too only in the sense of one sequential binary — for
    multi-host runs we replay the arena sequentially over ALL reads on
    every host (cheap: one memcpy per read) so each host's per-read
    buffers match the single-process run bit-for-bit;
  * records are written to per-process files; merge_outputs interleaves
    them back into single-process order.

Initialization uses jax.distributed when coordinator env vars are
present; otherwise this degrades to a single process.
"""

from __future__ import annotations

import os

from mtr.config import MTRConfig, DEFAULT_CONFIG


def init_distributed() -> tuple[int, int]:
    """Returns (process_index, process_count)."""
    import jax

    if os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    ):
        try:
            jax.distributed.initialize()
        except Exception:
            pass
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def run_file_sharded(
    path: str,
    out_path_prefix: str,
    cfg: MTRConfig = DEFAULT_CONFIG,
    process_index: int | None = None,
    process_count: int | None = None,
    checkpoint: bool = False,
    strict: bool = True,
):
    """Process this host's share of the reads; writes
    {out_path_prefix}.part{pid} plus a .meta file with the read indices
    handled (for the deterministic merge).

    Delegates to pipeline.run_file with a round-robin read filter, so
    the multi-host path inherits the single-process features verbatim:
    compute/IO overlap thread, per-batch failure isolation
    (strict=False), and exact checkpoint/resume (checkpoint=True resumes
    from {out_path_prefix}.ckpt{pid}, appending to the part files)."""
    from mtr.pipeline import run_file

    if process_index is None or process_count is None:
        process_index, process_count = init_distributed()

    ckpt_path = f"{out_path_prefix}.ckpt{process_index}" if checkpoint else None
    mode = "a" if checkpoint and os.path.exists(ckpt_path or "") else "w"
    out_f = open(f"{out_path_prefix}.part{process_index}", mode)
    meta_f = open(f"{out_path_prefix}.meta{process_index}", mode)
    try:
        run_file(
            path,
            cfg,
            out_f,
            checkpoint=ckpt_path,
            strict=strict,
            read_filter=lambda r: r % process_count == process_index,
            read_meta=lambda r, n: (
                meta_f.write(f"{r}\t{n}\n"), meta_f.flush())[0],
        )
    finally:
        out_f.close()
        meta_f.close()


def merge_outputs(out_path_prefix: str, process_count: int, out) -> None:
    """Deterministic single-process-order merge of per-host outputs."""
    parts = []
    for pid in range(process_count):
        lines = open(f"{out_path_prefix}.part{pid}").read().splitlines(True)
        meta = [
            (int(a), int(b))
            for a, b in (
                ln.split("\t") for ln in open(f"{out_path_prefix}.meta{pid}")
            )
        ]
        pos = 0
        for rid, n in meta:
            parts.append((rid, lines[pos : pos + n]))
            pos += n
    parts.sort(key=lambda t: t[0])
    for _rid, lines in parts:
        out.writelines(lines)
