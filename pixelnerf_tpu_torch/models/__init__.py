from .code import PositionalEncoding  # noqa: F401
from .encoder import ConvEncoder, ImageEncoder, SpatialEncoder, index_latent, latent_scaling  # noqa: F401
from .factory import init_weights, make_model  # noqa: F401
from .mlp import ImplicitNet  # noqa: F401
from .pixelnerf import PixelNeRFNet, SceneEncoding, bake_encoding, coarse_only, pack_encoding  # noqa: F401
from .resnetfc import ResnetFC  # noqa: F401
from .weights import (  # noqa: F401
    export_state_dict,
    from_jax_opt_state,
    from_jax_variables,
    load_jax_variables,
    load_pretrained_encoder,
    load_reference_state_dict,
)
