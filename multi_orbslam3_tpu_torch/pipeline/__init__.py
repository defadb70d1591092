"""Tracking, two-view initialization, local mapping and the monocular
system's host state machine."""
