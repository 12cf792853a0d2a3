from mediquery_rag_tpu_torch.serve.server import main

main()
