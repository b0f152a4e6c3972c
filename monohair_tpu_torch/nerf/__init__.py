"""Stage 1's coarse NeRF (run_ngp) and its pose chain: the Fourier, hash and
dense fields, the renderer and occupancy grid, training, the mesh export
through marching tetrahedra, the COLMAP converter."""
