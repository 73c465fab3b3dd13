"""Offline view-feature extraction: the ViT towers (vit.py), the
extraction pipeline (extract.py) and its command-line entry points
(extract_features_mp3d.py, extract_features_frames.py)."""
from .vit import ViTConfig, init_vit_params, vit_forward_features
