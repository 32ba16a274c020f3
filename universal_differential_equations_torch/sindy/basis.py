"""Candidate feature libraries for sparse regression (SURVEY.md C19).

Port of ``universal_differential_equations_tpu/sindy/basis.py``.  A library
is a static list of terms (polynomial exponent rows, trig terms, custom
callables) with one batched evaluation ``theta(X)`` and human-readable names
for equation rendering (``scenario_1.jl:176-190``).  The polynomial block is
exact integer powers from a cumulative-product table and a gather, so
negative bases never meet a float ``pow``.

The constructors mirror the reference's libraries: ``polynomial_basis(u, 5)`` plus
``sin.(u)`` (``scenario_1.jl:155-159``), ``monomial_basis(u, 10)``
(``scenario_3.jl:189-190``), and the SEIR tensor-grid monomials
(``seir_exposure.jl:193-200``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Term",
    "Basis",
    "polynomial_basis",
    "monomial_basis",
    "tensor_polynomial_basis",
    "sin_basis",
    "cos_basis",
]


@dataclasses.dataclass(frozen=True)
class Term:
    """One candidate feature.

    kind: 'poly' (exponents per variable), 'sin'/'cos' (single variable with
    integer frequency), or 'custom' (callable u -> scalar).
    """

    kind: str
    exponents: Tuple[int, ...] = ()
    var: int = 0
    freq: int = 1
    fn: Optional[Callable] = None
    label: Optional[str] = None

    def name(self, var_names) -> str:
        if self.label is not None:
            return self.label
        if self.kind == "poly":
            if all(e == 0 for e in self.exponents):
                return "1"
            parts = []
            for v, e in enumerate(self.exponents):
                if e == 1:
                    parts.append(var_names[v])
                elif e > 1:
                    parts.append(f"{var_names[v]}^{e}")
            return "*".join(parts)
        if self.kind in ("sin", "cos"):
            arg = var_names[self.var]
            if self.freq != 1:
                arg = f"{self.freq}*{arg}"
            return f"{self.kind}({arg})"
        return f"f{self.var}(u)"


@dataclasses.dataclass(frozen=True)
class Basis:
    """A candidate library over ``n_vars`` state variables."""

    terms: Tuple[Term, ...]
    n_vars: int
    var_names: Tuple[str, ...] = None

    def __post_init__(self):
        if self.var_names is None:
            object.__setattr__(
                self, "var_names", tuple(f"u{i+1}" for i in range(self.n_vars))
            )
        # index and coefficient tables, one copy per device and dtype (theta
        # runs at every RHS evaluation of a recovered model: no host copies)
        object.__setattr__(self, "_tables", {})

    def _table(self, name, device, build, dtype=None):
        key = (name, device, dtype)
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = torch.as_tensor(build(), dtype=dtype, device=device)
        return table

    def _exponent_table(self, device):
        return self._table("exponents", device, lambda: np.array(
            [t.exponents for t in self.terms if t.kind == "poly"], dtype=np.int64))

    def __len__(self):
        return len(self.terms)

    def __add__(self, other: "Basis") -> "Basis":
        assert other.n_vars == self.n_vars
        return Basis(self.terms + other.terms, self.n_vars, self.var_names)

    @property
    def names(self):
        return [t.name(self.var_names) for t in self.terms]

    def theta(self, X):
        """Feature matrix Θ(X): (N, n_vars) → (N, m); one state (n_vars,) → (m,)."""
        X = torch.as_tensor(X)
        single = X.ndim == 1
        if single:
            X = X[None, :]
        # one block per kind (it runs at every RHS evaluation of a recovered
        # model, so few ops), then the columns back into the terms' order
        blocks, where = [], []
        poly = [i for i, t in enumerate(self.terms) if t.kind == "poly"]
        if poly:
            E = self._exponent_table(X.device)  # (m, n)
            pows = [torch.ones_like(X)]
            for _ in range(max(max(self.terms[i].exponents) for i in poly)):
                pows.append(pows[-1] * X)
            table = torch.stack(pows, dim=0).permute(2, 0, 1)  # (n, D+1, N)
            var_idx = torch.arange(E.shape[1], device=X.device)[None, :]
            blocks.append(torch.prod(table[var_idx, E, :], dim=1).T)  # (N, m)
            where += poly
        for kind, fn in (("sin", torch.sin), ("cos", torch.cos)):
            trig = [i for i, t in enumerate(self.terms) if t.kind == kind]
            if trig:
                var = [self.terms[i].var for i in trig]
                arg = X if var == list(range(X.shape[1])) else X[:, self._table(
                    kind + "_var", X.device, lambda: np.array(var, dtype=np.int64))]
                freq = [float(self.terms[i].freq) for i in trig]
                if any(f != 1.0 for f in freq):
                    arg = arg * self._table(kind + "_freq", X.device, lambda: freq, X.dtype)
                blocks.append(fn(arg))
                where += trig
        for i, t in enumerate(self.terms):
            if t.kind not in ("poly", "sin", "cos"):
                blocks.append(torch.func.vmap(t.fn)(X)[:, None])
                where.append(i)
        out = torch.cat(blocks, dim=-1) if len(blocks) > 1 else blocks[0]
        if where != sorted(where):
            out = out[:, self._table("order", X.device, lambda: np.argsort(where))]
        return out[0] if single else out

    def __call__(self, X):
        return self.theta(X)


def polynomial_basis(n_vars: int, degree: int, include_constant: bool = True) -> Basis:
    """All monomials of total degree ≤ ``degree`` (DataDrivenDiffEq
    ``polynomial_basis``, ``scenario_1.jl:158``)."""
    terms = []
    for total in range(0 if include_constant else 1, degree + 1):
        for combo in itertools.combinations_with_replacement(range(n_vars), total):
            exps = [0] * n_vars
            for v in combo:
                exps[v] += 1
            terms.append(Term("poly", exponents=tuple(exps)))
    return Basis(tuple(terms), n_vars)


def monomial_basis(n_vars: int, degree: int) -> Basis:
    """Univariate powers u_i^k, k = 1..degree (``scenario_3.jl:189``)."""
    terms = []
    for v in range(n_vars):
        for k in range(1, degree + 1):
            exps = [0] * n_vars
            exps[v] = k
            terms.append(Term("poly", exponents=tuple(exps)))
    return Basis(tuple(terms), n_vars)


def tensor_polynomial_basis(n_vars: int, max_per_var: int) -> Basis:
    """Tensor grid u1^i·u2^j·… with each power ≤ ``max_per_var`` — the SEIR
    library's monomial block (``seir_exposure.jl:196-199``)."""
    terms = []
    for exps in itertools.product(range(max_per_var + 1), repeat=n_vars):
        terms.append(Term("poly", exponents=tuple(exps)))
    return Basis(tuple(terms), n_vars)


def sin_basis(n_vars: int, freqs: Sequence[int] = (1,)) -> Basis:
    terms = tuple(
        Term("sin", var=v, freq=k) for v in range(n_vars) for k in freqs
    )
    return Basis(terms, n_vars)


def cos_basis(n_vars: int, freqs: Sequence[int] = (1,)) -> Basis:
    terms = tuple(
        Term("cos", var=v, freq=k) for v in range(n_vars) for k in freqs
    )
    return Basis(terms, n_vars)
