from .conv import (Conv2dEncoder, Conv2dResBlock, ConvTranspose2d,
                   DeConv2dBlock, Interp2dEncoder, Interp2dUpsample, Shortcut2d)
from .encoder import SimpleTransformerEncoderLayer
from .layers import (FeedForward, Identity, SimpleAttention, SpectralConv1d,
                     SpectralConv2d)
from .regressor import PointwiseRegressor, SpectralRegressor
from .scaler import DownScaler, UpScaler
from .transformer import (FourierTransformer2D, SimpleTransformer,
                          inverse_transform)

__all__ = ["SimpleTransformerEncoderLayer", "FeedForward", "Identity",
           "SimpleAttention", "SpectralConv1d", "SpectralConv2d",
           "PointwiseRegressor", "SpectralRegressor", "Shortcut2d",
           "Conv2dResBlock", "Conv2dEncoder", "Interp2dEncoder",
           "ConvTranspose2d", "DeConv2dBlock", "Interp2dUpsample",
           "DownScaler", "UpScaler", "SimpleTransformer",
           "FourierTransformer2D", "inverse_transform"]
