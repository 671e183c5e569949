"""Milliseconds a thousand reads spend in the fused step's calls
(phase_s.step: the host's issue of the card's work and the wait at
download; stages/cli_step.py, pipeline.DeconRun._run_fast). Moves
reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "align_decon", "phase_s", "step")
