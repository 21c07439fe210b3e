from repro_torch.data.pipeline import DataConfig, TokenStream, data_kind

__all__ = ["DataConfig", "TokenStream", "data_kind"]
