from viforsdes_tpu_torch.parallel.mesh import DATA_AXIS, local_batch_size, make_data_mesh

__all__ = ["DATA_AXIS", "make_data_mesh", "local_batch_size"]
