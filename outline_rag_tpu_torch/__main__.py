from outline_rag_tpu_torch.main import main

if __name__ == "__main__":  # not on import: tests import every module of the package
    main()
