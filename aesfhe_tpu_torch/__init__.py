"""PyTorch/CUDA port of the CKKS engine and the homomorphic AES-128 of
`aesfhe_tpu` (the bit-sliced and the zeta nibble-pair pipelines), written
for one NVIDIA H100.

The JAX package stays the reference: every module here keeps its
counterpart's name, and the port imports neither `jax` nor `aesfhe_tpu`.
Residues are `torch.int32` tensors holding the reference's uint32 bits
(every prime is <= 2^30, so they are non-negative); plain torch code widens
them to int64 for products.  Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`.
"""
