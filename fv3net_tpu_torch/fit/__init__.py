"""fv3fit for the port (the JAX package's ``fit/``): the Predictor
contract, io and training registries, every family the JAX package
registers -- dense, precipitative, convolutional, reservoir, the
recurrent FMR, graph (MPG and UNet), autoencoder and CycleGAN -- plus the
port's transformed family, the composite models, the min/max and
one-class SVM novelty detectors and the scikit-learn random forest, with
the train CLI (``fit/train.py``).  The networks train on the CUDA device
unless the caller names another; the scikit-learn models are host code
and need scikit-learn.  Nothing of the JAX package's ``fit/`` waits to be
ported."""

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
from .reservoir import (
    train_reservoir_model,
    ReservoirHyperparameters,
    ReservoirComputingModel,
    Reservoir,
    RankDivider,
)
from .generative import (
    train_autoencoder,
    AutoencoderHyperparameters,
    AutoencoderModel,
    train_cyclegan,
    CycleGANHyperparameters,
    CycleGANModel,
)
from .sklearn_models import (
    train_random_forest,
    RandomForestHyperparameters,
    RandomForestModel,
    MinMaxNoveltyDetector,
    train_min_max_novelty_detector,
    OCSVMNoveltyDetector,
)
from .graph import (
    train_graph_model,
    GraphHyperparameters,
    GraphModel,
)
from .recurrent import (
    train_fmr_model,
    FMRHyperparameters,
    FMRModel,
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
    "train_reservoir_model",
    "ReservoirHyperparameters",
    "ReservoirComputingModel",
    "Reservoir",
    "RankDivider",
    "train_autoencoder",
    "AutoencoderHyperparameters",
    "AutoencoderModel",
    "train_cyclegan",
    "CycleGANHyperparameters",
    "CycleGANModel",
    "train_random_forest",
    "RandomForestHyperparameters",
    "RandomForestModel",
    "MinMaxNoveltyDetector",
    "train_min_max_novelty_detector",
    "OCSVMNoveltyDetector",
    "train_graph_model",
    "GraphHyperparameters",
    "GraphModel",
    "train_fmr_model",
    "FMRHyperparameters",
    "FMRModel",
    "TransformedPredictor",
    "train_transformed",
]
