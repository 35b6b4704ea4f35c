from .code import PositionalEncoding  # noqa: F401
from .encoder import SpatialEncoder, index_latent, latent_scaling  # noqa: F401
from .factory import init_weights, make_model  # noqa: F401
from .pixelnerf import PixelNeRFNet, SceneEncoding, bake_encoding, pack_encoding  # noqa: F401
from .resnetfc import ResnetFC  # noqa: F401
from .weights import from_jax_opt_state, from_jax_variables, load_jax_variables  # noqa: F401
