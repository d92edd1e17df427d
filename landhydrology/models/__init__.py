"""Model families.

The reference's model surface is the soil column model
(``/root/reference/src/Models.jl``, ``src/SoilModel/``); `AbstractModel` and
the `default_initial_conditions` hook live here as a light protocol.
"""

from landhydrology.models.base import AbstractModel

__all__ = ["AbstractModel"]
