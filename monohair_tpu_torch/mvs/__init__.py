"""Interior inference of stage 3 (port of monohair_tpu/mvs's evaluation half):
the DeepMVSHair occupancy and orientation nets over dense query points."""
