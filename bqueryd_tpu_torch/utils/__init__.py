from bqueryd_tpu_torch.utils.fs import mkdir_p, rm_file_or_dir

__all__ = ["mkdir_p", "rm_file_or_dir"]
