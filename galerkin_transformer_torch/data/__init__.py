from .burgers import BurgersDataset
from .darcy import darcy_grids, get_scaler_sizes
from .loader import DataLoader
from .normalizer import UnitGaussianNormalizer

__all__ = ["BurgersDataset", "DataLoader", "UnitGaussianNormalizer",
           "darcy_grids", "get_scaler_sizes"]
