"""Hair segmentation of stage 1: the MODNet matte and the BiSeNet parse
(torch modules named as the JAX package's flax modules), their runners and the
mask step."""
