"""Milliseconds a thousand reads spend in the host's assembly of the
fused step's outputs (phase_s.assemble; stages/cli_step.assemble_batch).
Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "align_decon", "phase_s", "assemble")
