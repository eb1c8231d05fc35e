"""mtr — an accelerator-native tandem-repeat detection framework.

Re-implements the full capability surface of the mTR reference tool
(directional-index repeat localization, de Bruijn unit inference,
wrap-around dynamic-programming alignment, unit polishing, interval
chaining) as a batched, device-accelerated framework built on
JAX/XLA (plus one CUDA kernel on the GPU) for the compute path and a
native C++ host runtime for
the sequential per-read logic.

Layering (top to bottom):
  cli              — mTR-compatible command line driver
  pipeline         — batched production pipeline (device kernels + host runtime)
  oracle/          — bit-exact NumPy reference implementation (the referee)
  ops/             — device engines (DI stencil, DBG walks, wrap-around DP)
  parallel/        — jax.sharding mesh utilities, multi-chip data parallelism
  chaining         — interval chaining + record output
  io/, utils/      — FASTA streaming, MT19937, encodings, timers
  testutil/        — synthetic data generators and accuracy evaluators
"""

__version__ = "0.1.0"

from mtr.config import MTRConfig  # noqa: F401


def find_repeats(sequences, config: "MTRConfig | None" = None):
    """Programmatic entry point: detect tandem repeats in sequences.

    sequences: a str/bytes DNA sequence, or an iterable of them (or of
    (read_id, sequence) pairs).  Returns a list of per-read lists of
    RepeatRecord — fields mirror the reference's output record
    (mTR.h:99-119) plus the unit string.  Semantics are identical to
    running the CLI on a FASTA with the same reads in the same order.
    """
    import io
    import tempfile
    import os

    if isinstance(sequences, (str, bytes)):
        sequences = [sequences]
    cfg = config or MTRConfig()
    from mtr.pipeline import run_file

    order: list[str] = []
    with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
        path = f.name
        for idx, item in enumerate(sequences):
            if isinstance(item, tuple):
                rid, seq = item
            else:
                rid, seq = str(idx), item
            if isinstance(seq, bytes):
                seq = seq.decode()
            order.append(rid)
            f.write(f">{rid}\n{seq}\n")
    try:
        per_read: dict[str, list] = {rid: [] for rid in order}

        def sink(rec):
            per_read[rec.read_id].append(rec)

        run_file(path, cfg, io.StringIO(), record_sink=sink)
        return [per_read[rid] for rid in order]
    finally:
        os.unlink(path)
