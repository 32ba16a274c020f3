from . import fisher_kpp

__all__ = ["fisher_kpp"]
