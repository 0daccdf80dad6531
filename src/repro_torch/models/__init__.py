"""Model zoo of the port: the full-sequence dense decoder (attention blocks
with a dense MLP) of ``repro.models``, and the converter that carries a
reference parameter tree across."""
from .common import pdef, tree_axes, tree_init
from .convert import params_from_numpy, params_to_numpy, state_from_numpy
from .transformer import (count_params, forward, init_params, lm_loss,
                          param_axes, param_defs)
