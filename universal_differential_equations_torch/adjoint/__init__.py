from .sensitivity import AbstractAdjoint, DiscreteAdjoint, ForwardSensitivity, NoAdjoint

__all__ = ["AbstractAdjoint", "DiscreteAdjoint", "ForwardSensitivity", "NoAdjoint"]
