from .burgers import BurgersDataset
from .darcy import DarcyDataset, darcy_grids, get_scaler_sizes
from .loader import DataLoader
from .normalizer import UnitGaussianNormalizer

__all__ = ["BurgersDataset", "DarcyDataset", "DataLoader", "UnitGaussianNormalizer",
           "darcy_grids", "get_scaler_sizes"]
