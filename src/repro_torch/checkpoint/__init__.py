from .checkpointer import (AsyncCheckpointer, Checkpointer,  # noqa: F401
                           latest_step, restore, save)
