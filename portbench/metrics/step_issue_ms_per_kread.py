"""Milliseconds a thousand reads spend in the fused step's calls (the
decon.step.issue span: the host issuing the card's work, and the one wait
at the extension's re-round test; stages/cli_step.py). With
step_wait_ms_per_kread it makes step_ms_per_kread. Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "decon.step.issue")
