from pstl_tpu_torch.data.synthetic import generate_dataset, generate_scene  # noqa: F401
