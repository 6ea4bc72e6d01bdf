from .optim import make_optimizer, make_schedule

__all__ = ["make_optimizer", "make_schedule"]
