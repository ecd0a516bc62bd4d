from rocm_apex_tpu_torch.amp.lists import (  # noqa: F401
    functional_overrides,
    torch_overrides,
)
