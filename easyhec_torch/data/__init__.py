from .dataset import CalibBatch, load_calib_dataset, save_calib_dataset, save_calib_frame

__all__ = ["CalibBatch", "load_calib_dataset", "save_calib_dataset", "save_calib_frame"]
