from .conv import (Conv2dEncoder, Conv2dResBlock, ConvTranspose2d,
                   DeConv2dBlock, Interp2dEncoder, Interp2dUpsample, Shortcut2d)
from .encoder import (GalerkinTransformerDecoderLayer, MultiHeadDotProductAttention,
                      SimpleTransformerEncoderLayer, VanillaTransformerEncoderLayer)
from .graph import GAT, GCN, EdgeEncoder, GraphAttention, GraphConvolution
from .layers import (BulkRegressor, FeedForward, Identity, PositionalEncoding,
                     SimpleAttention, SpectralConv1d, SpectralConv2d, get_activation)
from .regressor import PointwiseRegressor, SpectralRegressor
from .scaler import DownScaler, UpScaler
from .transformer import (FourierTransformer2D, FourierTransformer2DLite,
                          SimpleTransformer, inverse_transform)

__all__ = ["SimpleTransformerEncoderLayer", "GalerkinTransformerDecoderLayer",
           "VanillaTransformerEncoderLayer", "MultiHeadDotProductAttention", "FeedForward",
           "Identity", "PositionalEncoding", "BulkRegressor", "SimpleAttention",
           "SpectralConv1d", "SpectralConv2d", "get_activation",
           "GraphConvolution", "GraphAttention", "EdgeEncoder", "GCN", "GAT",
           "PointwiseRegressor", "SpectralRegressor", "Shortcut2d",
           "Conv2dResBlock", "Conv2dEncoder", "Interp2dEncoder",
           "ConvTranspose2d", "DeConv2dBlock", "Interp2dUpsample",
           "DownScaler", "UpScaler", "SimpleTransformer",
           "FourierTransformer2D", "FourierTransformer2DLite", "inverse_transform"]
