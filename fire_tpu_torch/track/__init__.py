"""SORT tracking with the linear-KF specialisation of the 10-dim UKF."""
