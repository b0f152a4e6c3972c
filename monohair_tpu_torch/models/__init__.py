"""The DeepMVSHair nets of stage 3 (port of monohair_tpu/models' UNet, ViT and
pifu heads): torch modules named as the reference's torch modules, so a
DeepMVSHair ``.pth`` state dict loads with ``load_state_dict``."""
