from repro_torch.ckpt.checkpoint import (all_checkpoint_steps,  # noqa: F401
                                         extract_delta, latest_intact_step,
                                         latest_step, load_checkpoint_arrays,
                                         restore_checkpoint, restore_tree,
                                         save_checkpoint,
                                         sweep_tmp_dirs, verify_checkpoint)
