"""Milliseconds a thousand reads spend downloading the fused step's outputs
(the decon.step.download span: the host waiting for the card at .cpu() in
pipeline.DeconRun._run_fast's drain). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "decon.step.download")
