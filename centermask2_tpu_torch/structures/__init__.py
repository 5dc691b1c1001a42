from . import boxes

__all__ = ["boxes"]
