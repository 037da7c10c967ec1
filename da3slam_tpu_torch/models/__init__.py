"""The DA3 network as nn.Modules, its presets, the JAX-weight converter,
checkpoint directories, the torch-checkpoint import and the nested tier."""


def load_model(name: str, seed: int = 0, device="cuda"):
    """The model ``name`` names: a VGGT preset (``VGGT-1B``, ``vggt-tiny``;
    ``vggt.py``) or anything ``DepthAnything3.from_pretrained`` takes (a DA3
    or nested preset, or a checkpoint directory)."""
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.models.vggt import VGGT, vggt_preset

    if vggt_preset(name) is not None:
        print(f"Loading VGGT model {name}...")
        return VGGT.from_pretrained(name, seed=seed, device=device)
    print(f"Loading DA3 model from {name}...")
    return DepthAnything3.from_pretrained(name, seed=seed, device=device)
