from .classifier import (  # noqa: F401
    RiskClassifier,
    SVMModel,
    load_label_file,
    poly3_features,
)
