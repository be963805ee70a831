from repro_torch.workloads.models import MODEL_ZOO, model_layers, TASK_MODELS
from repro_torch.workloads.benchmark import Job, JobGroup, build_task_groups

__all__ = ["MODEL_ZOO", "model_layers", "TASK_MODELS",
           "Job", "JobGroup", "build_task_groups"]
