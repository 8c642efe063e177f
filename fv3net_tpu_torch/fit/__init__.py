"""fv3fit for the port (the JAX package's ``fit/``): the Predictor
contract, io and training registries, and the families ported so far --
dense, precipitative, convolutional and transformed, the composite
models and the min/max novelty detector -- with the train CLI
(``fit/train.py``).  The reservoir, generative, graph and recurrent
families and the scikit-learn models are not ported (ROADMAP)."""

from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    dump,
    load,
    register,
    TRAINING_FUNCTIONS,
    register_training_function,
    get_training_function,
    TrainingConfig,
)
from .models import (
    ConstantOutputPredictor,
    DerivedModel,
    EnsembleModel,
    CombinedOutputModel,
    OutOfSampleModel,
    TaperedModel,
)
from .dense import DenseModel, train_dense_model, DenseHyperparameters
from .convolutional import (
    train_convolutional_model,
    ConvolutionalHyperparameters,
    ConvolutionalModel,
    append_halos,
)
from .precipitative import (
    train_precipitative_model,
    PrecipitativeHyperparameters,
    PrecipitativeModel,
)
from .sklearn_models import (
    MinMaxNoveltyDetector,
    train_min_max_novelty_detector,
)
from .transformed import TransformedPredictor, train_transformed

__all__ = [
    "ArrayPacker",
    "Predictor",
    "StandardScaler",
    "dump",
    "load",
    "register",
    "TRAINING_FUNCTIONS",
    "register_training_function",
    "get_training_function",
    "TrainingConfig",
    "ConstantOutputPredictor",
    "DerivedModel",
    "EnsembleModel",
    "CombinedOutputModel",
    "OutOfSampleModel",
    "TaperedModel",
    "DenseModel",
    "train_dense_model",
    "DenseHyperparameters",
    "train_convolutional_model",
    "ConvolutionalHyperparameters",
    "ConvolutionalModel",
    "append_halos",
    "train_precipitative_model",
    "PrecipitativeHyperparameters",
    "PrecipitativeModel",
    "MinMaxNoveltyDetector",
    "train_min_max_novelty_detector",
    "TransformedPredictor",
    "train_transformed",
]
