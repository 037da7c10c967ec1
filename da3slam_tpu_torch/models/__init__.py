"""The DA3 network as nn.Modules, its presets, the JAX-weight converter,
checkpoint directories, the torch-checkpoint import and the nested tier."""
