"""SORT tracking with the linear-KF specialisation of the 10-dim UKF."""

from fire_tpu_torch.track.sort import Sort, TrackTable, sort_step  # noqa: F401
from fire_tpu_torch.track.ukf import MerweUKF, kf_predict, kf_update  # noqa: F401
