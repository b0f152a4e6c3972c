"""Bust-side plumbing of stage 1. Only the fitted-transform application is
ported so far; the SMPL-X bust fit itself is not."""
