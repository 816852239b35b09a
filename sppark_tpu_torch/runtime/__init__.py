from .devices import (all_devices, ndevices, select_device, device_props,
                      resolve)
from .timer import DeviceTimer, time_ms
from .dev_ptr import DevPtr

__all__ = ["all_devices", "ndevices", "select_device", "device_props",
           "resolve", "DeviceTimer", "time_ms", "DevPtr"]
