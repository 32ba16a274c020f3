"""Tsitouras 5(4) (C. Tsitouras, "Runge-Kutta pairs of order 5(4) satisfying
only the first column simplifying assumption", 2011): a frozen copy of the
stage table, the nodes and the weights of the propagated solution.  The
tableau is first-same-as-last: the last stage is the next step's first."""

C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)

A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
     -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)

B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774, 0.0)


def step(f, y, k1, dt):
    """One step from ``y`` with ``k1 = f(y)`` (the right-hand sides here do
    not depend on time); returns ``(y_next, f(y_next))``."""
    ks = [k1]
    for row in A[1:]:
        acc = None
        for a, k in zip(row, ks):
            if a != 0.0:
                term = a * k
                acc = term if acc is None else acc + term
        ks.append(f(y + dt * acc))
    acc = None
    for b, k in zip(B, ks):
        if b != 0.0:
            term = b * k
            acc = term if acc is None else acc + term
    y_next = y + dt * acc
    # first-same-as-last: the last stage sits at y_next
    return y_next, ks[-1]
