from raytrace2_tpu_torch.app import main

if __name__ == "__main__":
    raise SystemExit(main())
