"""Abstract model protocol.

Mirrors ``/root/reference/src/Models.jl:11-17``: an abstract supertype plus a
``default_initial_conditions`` hook that concrete models override.  Here a
"model" is a static (hashable or pytree) configuration object;
the dynamics it induces are pure functions built by ``make_rhs(model)``.
"""

from __future__ import annotations


class AbstractModel:
    """Base class for models (cf. ``src/Models.jl:11``).

    Subclasses are configuration lattices: frozen dataclasses whose fields
    select pure functions.  They must implement
    :meth:`default_initial_conditions` or raise.
    """

    #: name under which prognostic state is nested in the state dict
    name: str = "model"

    def default_initial_conditions(self):
        raise NotImplementedError(
            "No default initial conditions exist for this model type."
        )
