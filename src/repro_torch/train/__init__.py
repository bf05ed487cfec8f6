from repro_torch.train import checkpoint, data, losses, optimizer, train_loop
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import make_train_step, train

__all__ = ["checkpoint", "data", "losses", "optimizer", "train_loop",
           "DataConfig", "SyntheticLM", "AdamWConfig", "make_train_step",
           "train"]
