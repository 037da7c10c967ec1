"""The DA3 network as nn.Modules, its presets, the JAX-weight converter and
checkpoint directories."""
