from repro_torch.configs.base import get_config, list_archs, reduce_for_smoke

__all__ = ["get_config", "list_archs", "reduce_for_smoke"]
