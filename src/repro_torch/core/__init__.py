"""Core library of the port: encoders, straggler delay models, the encoded
data-parallel problem, encoded L-BFGS and the lifted (model-parallel)
problem (counterpart of ``repro.core``)."""
from .encoding import (LinearEncoder, Encoder, DenseEncoder, as_dense,
                       make_encoder, register_encoder, available_encoders,
                       gaussian_encoder, hadamard_encoder, haar_encoder,
                       paley_etf_encoder, steiner_etf_encoder,
                       replication_encoder, identity_encoder, partition_rows,
                       pad_rows, brip_constant, subset_spectrum,
                       hadamard_matrix, hadamard_ensemble)
from .operators import FastHadamardEncoder, BlockDiagonalEncoder
from .straggler import (bimodal_delays, power_law_delays, exponential_delays,
                        multimodal_delays, constant_delays, fastest_k,
                        active_mask, adversarial_sets, simulate_run, WallClock,
                        adaptive_k)
from .data_parallel import (EncodedProblem, make_encoded_problem,
                            encoded_gradients, masked_gradient, gd_step,
                            run_encoded_gd, prox_l1, prox_step,
                            run_encoded_proximal, original_objective)
from .lbfgs import LBFGSState, lbfgs_direction, run_encoded_lbfgs
from .model_parallel import (LiftedProblem, make_lifted_problem, phi_quadratic,
                             phi_logistic, run_encoded_bcd)
