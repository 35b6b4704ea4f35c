from .loss import make_render_loss, rgb_loss, rgb_loss_with_uncertainty  # noqa: F401
from .state import load_checkpoint, load_variables, save_checkpoint  # noqa: F401
from .step import make_eval_step, make_train_step  # noqa: F401
