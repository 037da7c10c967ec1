"""The DA3 network as nn.Modules, its presets and the JAX-weight converter."""
