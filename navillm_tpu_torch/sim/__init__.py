"""The port's host-side simulator: a copy of navillm_tpu/sim (geometry,
scan and episode graphs, the render-free environment, the native
library), so the port imports nothing of the JAX package."""
from .geometry import (angle_feature, all_point_angle_features,
                       rel_heading_elevation_dist, rel_pos_features,
                       normalize_angle, convert_heading, convert_elevation,
                       position_distance, NUM_VIEWS, RAD30, MAX_DIST, MAX_STEP)
from .graph import ScanGraph, EpisodeGraph, load_connectivity
from .env import WorldModel, EpisodeBatch, Candidate, SimState, discretize
from .native import native_available
