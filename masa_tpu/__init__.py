"""masa_tpu — long-sequence alignment engine in JAX (CUDA on NVIDIA GPUs).

The library's one-call entry point:

    import masa_tpu
    aln = masa_tpu.align("chr1.fa", "chr2.fa")            # FASTA paths
    aln = masa_tpu.align(seq0_bytes, seq1_bytes)          # raw sequences
    print(aln.raw_score, aln.start, aln.end)

CLI: ``python -m masa_tpu a.fa b.fa`` (see --help for the full flag set).
The stage pipeline, aligner/manager contracts, and distributed drivers
live in the subpackages (stages/, core/, parallel/, ops/).
"""

from masa_tpu.types import AlignmentStart, Recurrence, ScoreParams

__all__ = ["align", "AlignmentStart", "Recurrence", "ScoreParams"]

__version__ = "0.3.0"


def align(seq0, seq1, *, alignment_start="*", alignment_end=None,
          match=1, mismatch=-3, gap_open=3, gap_ext=2,
          backend="auto", max_cells_stage5=1 << 18):
    """Exact pairwise alignment with full traceback (the six-stage
    pipeline on raw inputs; no work directory, no persistence — use
    stages.runner/the CLI for resumable chromosome-scale runs).

    ``seq0``/``seq1``: FASTA file path, bytes/str, or a uint8 array.
    ``alignment_start``/``alignment_end``: '*' local, '!' global,
    '1'/'2'/'+' semi-global (the CLI's flag values).
    Returns a ``biology.alignment.Alignment``.
    """
    import numpy as np

    from masa_tpu.models.scoring import encode_sequence
    from masa_tpu.stages import pipeline

    def load(x):
        if isinstance(x, str) and "\n" not in x:
            import os

            path_like = (x.endswith((".fa", ".fasta", ".fna"))
                         or os.sep in x)
            if os.path.exists(x):
                from masa_tpu.biology.sequence import Sequence

                return Sequence.from_file(x).data()
            if path_like:
                # never silently align a pathname's bytes
                raise FileNotFoundError(x)
        if isinstance(x, np.ndarray):
            return np.asarray(x, np.uint8)
        return encode_sequence(x)

    starts = {"*": AlignmentStart.ANYWHERE,
              "1": AlignmentStart.SEQUENCE_1,
              "2": AlignmentStart.SEQUENCE_2,
              "+": AlignmentStart.SEQUENCE_1_OR_2,
              "!": AlignmentStart.SEQUENCE_1_AND_2}
    pcfg = pipeline.PipelineConfig(
        params=ScoreParams(match, mismatch, gap_open, gap_ext),
        alignment_start=starts[alignment_start],
        alignment_end=(starts[alignment_end] if alignment_end else None),
        backend=backend,
        max_cells_stage5=max_cells_stage5,
    )
    return pipeline.align_pair(load(seq0), load(seq1), pcfg)
