from pstl_tpu_torch.models.net import Net, normalize_xyth, pos_encoding  # noqa: F401
