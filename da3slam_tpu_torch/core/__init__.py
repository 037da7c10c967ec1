"""SE(3)/Sim(3) algebra and pinhole geometry on torch tensors."""
