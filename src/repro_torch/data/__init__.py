from repro_torch.data.synthetic import make_mag_like

__all__ = ["make_mag_like"]
