from .checkpoint import BestCheckpoint, KeyedArchive, load_pytree, save_pytree

__all__ = ["BestCheckpoint", "KeyedArchive", "load_pytree", "save_pytree"]
