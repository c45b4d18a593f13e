from calipso_tpu_torch.utils.norms import norm_p, inf_norm, one_norm

__all__ = ["norm_p", "inf_norm", "one_norm"]
