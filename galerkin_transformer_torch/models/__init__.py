from .encoder import SimpleTransformerEncoderLayer
from .layers import FeedForward, Identity, SimpleAttention, SpectralConv1d
from .regressor import SpectralRegressor
from .transformer import SimpleTransformer, inverse_transform

__all__ = ["SimpleTransformerEncoderLayer", "FeedForward", "Identity",
           "SimpleAttention", "SpectralConv1d", "SpectralRegressor",
           "SimpleTransformer", "inverse_transform"]
