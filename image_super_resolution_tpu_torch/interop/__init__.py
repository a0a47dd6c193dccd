"""Interop with reference PyTorch artifacts (TorchScript files, training
checkpoints, reference-layout state dicts) and the JAX package's trees."""

from .torch_export import (
    conv_kernel_to_torch,
    export_denoiser_state,
    export_discriminator_state,
    export_generator_state,
    linear_to_torch,
    save_torch_state_dict,
)
from .torch_import import (
    conv_kernel_to_flax,
    import_basicvsr_state,
    import_denoiser_state,
    import_discriminator_state,
    import_generator_state,
    import_legacy_denoiser_state,
    import_rcan_state,
    import_torchscript_artifact,
    linear_to_flax,
    state_dict_from_reference_checkpoint,
    torchscript_state_dict,
)

__all__ = [
    "conv_kernel_to_flax",
    "conv_kernel_to_torch",
    "export_denoiser_state",
    "export_discriminator_state",
    "export_generator_state",
    "import_basicvsr_state",
    "linear_to_torch",
    "save_torch_state_dict",
    "import_denoiser_state",
    "import_discriminator_state",
    "import_generator_state",
    "import_legacy_denoiser_state",
    "import_rcan_state",
    "import_torchscript_artifact",
    "linear_to_flax",
    "state_dict_from_reference_checkpoint",
    "torchscript_state_dict",
]
