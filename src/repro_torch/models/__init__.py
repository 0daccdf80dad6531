"""Model zoo of the port (``repro.models``): every architecture's blocks
(attention with KV caches, MoE, Mamba, mLSTM / sLSTM, the whisper encoder,
patch inputs with M-RoPE), the three execution paths (``forward``,
``prefill``, ``decode_step``), the decode step captured as one device
program (``Decoder``) and the converter that carries a reference
parameter or cache tree across."""
from .attention import (AttnCache, decode_attend, init_kv_cache,
                        ring_slot_positions)
from .common import pdef, tree_axes, tree_init
from .convert import (caches_from_numpy, caches_to_numpy, params_from_numpy,
                      params_to_numpy, state_from_numpy)
from .decoder import Decoder
from .mamba import MambaCache, init_mamba_cache, mamba_apply, mamba_decode
from .moe import capacity_drops, moe_apply, moe_capacity
from .transformer import (Model, count_params, decode_step, forward,
                          init_caches, init_params, lm_loss, param_axes,
                          param_defs, prefill)
from .xlstm import (MLSTMCache, SLSTMCache, init_mlstm_cache,
                    init_slstm_cache, mlstm_apply, mlstm_decode, slstm_apply,
                    slstm_decode)
