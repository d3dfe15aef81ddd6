from .burgers import BurgersDataset
from .loader import DataLoader

__all__ = ["BurgersDataset", "DataLoader"]
