from .conv import (Conv2dEncoder, Conv2dResBlock, ConvTranspose2d,
                   DeConv2dBlock, Interp2dEncoder, Interp2dUpsample, Shortcut2d)
from .encoder import (MultiHeadDotProductAttention, SimpleTransformerEncoderLayer,
                      VanillaTransformerEncoderLayer)
from .layers import (BulkRegressor, FeedForward, Identity, PositionalEncoding,
                     SimpleAttention, SpectralConv1d, SpectralConv2d)
from .regressor import PointwiseRegressor, SpectralRegressor
from .scaler import DownScaler, UpScaler
from .transformer import (FourierTransformer2D, FourierTransformer2DLite,
                          SimpleTransformer, inverse_transform)

__all__ = ["SimpleTransformerEncoderLayer", "VanillaTransformerEncoderLayer",
           "MultiHeadDotProductAttention", "FeedForward", "Identity",
           "PositionalEncoding", "BulkRegressor", "SimpleAttention", "SpectralConv1d", "SpectralConv2d",
           "PointwiseRegressor", "SpectralRegressor", "Shortcut2d",
           "Conv2dResBlock", "Conv2dEncoder", "Interp2dEncoder",
           "ConvTranspose2d", "DeConv2dBlock", "Interp2dUpsample",
           "DownScaler", "UpScaler", "SimpleTransformer",
           "FourierTransformer2D", "FourierTransformer2DLite", "inverse_transform"]
