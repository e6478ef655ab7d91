"""Segmentation utilities: morphology, distance transforms, mask edges and
surface distances."""
from torchmetrics_tpu_torch.functional.segmentation.utils import (
    binary_erosion,
    check_if_binarized,
    distance_transform,
    generate_binary_structure,
    get_neighbour_tables,
    mask_edges,
    surface_distance,
    table_contour_length,
    table_surface_area,
)

__all__ = [
    "binary_erosion",
    "check_if_binarized",
    "distance_transform",
    "generate_binary_structure",
    "get_neighbour_tables",
    "mask_edges",
    "surface_distance",
    "table_contour_length",
    "table_surface_area",
]
