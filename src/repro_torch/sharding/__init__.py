"""Logical-axis placement rules of the port (``repro.sharding``)."""
from .rules import (NamedSharding, axis_size, batch_axes, logical_rules,
                    make_shardings, make_specs, placements_for,
                    spec_for_shape)
