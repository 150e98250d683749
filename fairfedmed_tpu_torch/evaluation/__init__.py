from . import metrics
from .distance import compute_distance_matrix, cosine_distance, euclidean_squared_distance
from .evaluator import Classification, Classification_oph, build_evaluator

__all__ = ["metrics", "Classification", "Classification_oph", "build_evaluator",
           "compute_distance_matrix", "cosine_distance", "euclidean_squared_distance"]
