from herald_tpu_torch.launch.cli import main

raise SystemExit(main())
