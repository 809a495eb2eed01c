from .pipeline import (MarkovDataset, RandomTokenDataset, ShardedLoader,  # noqa: F401
                       make_dataset)
