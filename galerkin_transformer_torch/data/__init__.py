from .burgers import BurgersDataset
from .darcy import DarcyDataset, darcy_grids, get_scaler_sizes
from .loader import DataLoader
from .normalizer import UnitGaussianNormalizer
from .ns import NavierStokesDatasetLite, ns_grids

__all__ = ["BurgersDataset", "DarcyDataset", "DataLoader", "NavierStokesDatasetLite",
           "UnitGaussianNormalizer", "darcy_grids", "get_scaler_sizes", "ns_grids"]
