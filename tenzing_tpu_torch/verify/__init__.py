"""Independent schedule-soundness verification (verify/soundness.py)."""

from tenzing_tpu_torch.verify.soundness import (  # noqa: F401
    ScheduleVerifier,
    Soundness,
    Violation,
    happens_before_masks,
    project_graph,
    verify_schedule,
)
