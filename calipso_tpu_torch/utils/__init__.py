from calipso_tpu_torch.utils.norms import norm_p, inf_norm, one_norm
from calipso_tpu_torch.utils.platform import host_callbacks_supported

__all__ = ["norm_p", "inf_norm", "one_norm", "host_callbacks_supported"]
