"""Training for the port; only ``data_gen.native_voxel_shift`` so far."""
