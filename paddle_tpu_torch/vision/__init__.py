"""paddle.vision of the PyTorch port (counterpart of
``paddle_tpu/vision``): the model zoo (``vision.models``). The datasets,
transforms and detection ops are not ported yet (ROADMAP Queue 1 item
10)."""
from . import models  # noqa: F401
