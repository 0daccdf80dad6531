"""Logical-axis placement rules of the port (``repro.sharding``)."""
from .rules import (NamedSharding, axis_size, batch_axes, batch_on_data,
                    logical_rules, make_shardings, make_specs,
                    placements_for, seq_on_data, spec_for_shape)
