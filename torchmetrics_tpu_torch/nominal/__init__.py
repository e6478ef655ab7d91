from torchmetrics_tpu_torch.nominal.metrics import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
