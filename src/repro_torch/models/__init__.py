from .common import BlockSpec, ModelConfig  # noqa: F401
from .registry import ModelAPI, build  # noqa: F401
