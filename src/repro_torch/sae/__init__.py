from .model import SAEConfig, sae_init, sae_apply, huber, sae_loss, accuracy
from .data import make_classification, make_lung_surrogate, train_test_split
from .train import SAETrainConfig, SAEResult, projected_step, train_sae
from .serve import (compact_leaf, CompactSAE, compact_sae, make_serve_step,
                    LeafSupport, support_selection)
