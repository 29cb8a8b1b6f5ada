"""One-shot federated learning — the paper's primary contribution.

svm.py        local RBF dual SVMs (SDCA)            [paper Sec. 3, Eq. 2]
ensemble.py   mean-prediction ensembles F_k         [paper Sec. 3]
selection.py  cv / data / random selection          [paper Sec. 3]
distill.py    dual-space distillation               [paper Sec. 3, Eq. 3]
protocol.py   end-to-end one-shot round + comm accounting
averaging.py  one-shot parameter-averaging baseline [related work [8]]
fedavg.py     iterative FedAvg baseline             [related work [5]]
cohorts.py    cohort-personalized ensembles         [future work (1)]
deepfed.py    transformer instantiation (the dense LM family)
fewshot.py    few-shot rounds over deepfed          [future work (3)]
"""
from repro_torch.core.svm import SVMModel, ConstantModel, train_svm, default_gamma, validation_auc
from repro_torch.core.ensemble import Ensemble, StackedEnsemble, ensemble_predict_mean
from repro_torch.core.selection import (
    DeviceReport, cv_selection, data_selection, random_selection, select,
)
from repro_torch.core.distill import distill_svm, distill_loss_l2, distill_loss_kl, DISTILL_LOSSES
from repro_torch.core.protocol import run_protocol, ProtocolResult
from repro_torch.core.averaging import (
    average_params, LinearSVM, train_linear_svm, one_shot_average_linear,
)
from repro_torch.core.fedavg import run_fedavg, FedAvgResult
from repro_torch.core import cohorts, deepfed, fewshot

__all__ = [
    "SVMModel", "ConstantModel", "train_svm", "default_gamma", "validation_auc",
    "Ensemble", "StackedEnsemble", "ensemble_predict_mean",
    "DeviceReport", "cv_selection", "data_selection", "random_selection", "select",
    "distill_svm", "distill_loss_l2", "distill_loss_kl", "DISTILL_LOSSES",
    "run_protocol", "ProtocolResult",
    "average_params", "LinearSVM", "train_linear_svm", "one_shot_average_linear",
    "run_fedavg", "FedAvgResult", "cohorts", "deepfed", "fewshot",
]
