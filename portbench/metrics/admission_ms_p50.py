"""admission_ms_p50: median host time of one admission (the engine's own
timing of each prefill, ``_admit_times``), over the window's admissions."""

from portbench.readers import admission_ms_p50 as read  # noqa: F401
