"""IMU preintegration (counterpart of multi_orbslam3_tpu/imu)."""
