from .devices import (accelerator_available, all_devices, ndevices,
                      select_device, device_props, resolve)
from .timer import DeviceTimer, time_ms
from .dev_ptr import DevPtr

__all__ = ["all_devices", "ndevices", "select_device", "device_props",
           "accelerator_available", "resolve", "DeviceTimer", "time_ms",
           "DevPtr"]
